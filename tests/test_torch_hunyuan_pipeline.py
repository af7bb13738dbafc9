"""The port's HunyuanVideo text-to-video pipeline end to end against the JAX
package's, on tiny configs with the same weights, tokenizer and latents.

Both pipelines run in float32 on the CPU; the JAX one with the "xla"
provider, the port's with its default "flash" provider (K7's plain version
on CPU tensors) and with "xla". The latents are passed in: torch cannot
draw JAX's random numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.models.hunyuan_video import HunyuanVideoConfig as JaxConfig
from vap_tpu.models.hunyuan_video import init_hunyuan_video
from vap_tpu.models.hunyuan_video.vae import HunyuanVideoVAEConfig as JaxVAEConfig
from vap_tpu.models.hunyuan_video.vae import init_hunyuan_vae
from vap_tpu.models.text_encoders.clip_text import CLIPTextConfig as JaxCLIPConfig
from vap_tpu.models.text_encoders.clip_text import init_clip_text
from vap_tpu.models.text_encoders.llama import LlamaConfig as JaxLlamaConfig
from vap_tpu.models.text_encoders.llama import init_llama
from vap_tpu.pipelines.hunyuan_video import HunyuanVideoPipeline as JaxPipeline
from vap_tpu_torch import convert
from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from vap_tpu_torch.models.hunyuan_video.vae import (AutoencoderKLHunyuanVideo,
                                                    HunyuanVideoVAEConfig)
from vap_tpu_torch.models.text_encoders.clip_text import CLIPTextConfig, CLIPTextModel
from vap_tpu_torch.models.text_encoders.llama import LlamaConfig, LlamaModel
from vap_tpu_torch.ops.attention import attention_provider
from vap_tpu_torch.pipelines.hunyuan_video import (HunyuanVideoPipeline, flow_sigmas,
                                                   shift_sigmas_constant)

# float32 through 2 steps of the tiny transformer and the tiny VAE (latents
# up to ~3.4, the decode clipped to [-1, 1]): summation order alone, which
# reads ~2e-6 here; 2e-5 leaves room for another BLAS
LATENT_ATOL = 2e-5
VIDEO_ATOL = 2e-5


class FakeTokenizer:
    """The JAX pipeline test's tokenizer: character ids, right-padded."""

    def __call__(self, texts, padding=None, max_length=8, truncation=True,
                 return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:max_length]):
                ids[i, j] = (ord(ch) * 3 + j) % 50 + 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


class LeftPaddingTokenizer(FakeTokenizer):
    def __call__(self, texts, **kw):
        toks = super().__call__(texts, **kw)
        return {k: v[:, ::-1].copy() for k, v in toks.items()}


@pytest.fixture(scope="module")
def pipes():
    vae_cfg = JaxVAEConfig.tiny()
    t_cfg = JaxConfig.tiny(in_channels=vae_cfg.latent_channels,
                           out_channels=vae_cfg.latent_channels)
    llama_cfg = JaxLlamaConfig.tiny(hidden_size=t_cfg.text_embed_dim, num_attention_heads=2,
                                    num_key_value_heads=2, vocab_size=64)
    clip_cfg = JaxCLIPConfig.tiny(hidden_size=t_cfg.pooled_projection_dim, num_attention_heads=4)
    key = jax.random.PRNGKey(0)
    params = {
        "transformer": init_hunyuan_video(key, t_cfg, jnp.float32),
        "vae": init_hunyuan_vae(jax.random.fold_in(key, 1), vae_cfg, jnp.float32),
        "text_encoder": init_llama(jax.random.fold_in(key, 2), llama_cfg, jnp.float32),
        "text_encoder_2": init_clip_text(jax.random.fold_in(key, 3), clip_cfg, jnp.float32),
    }
    jpipe = JaxPipeline(t_cfg, vae_cfg, llama_cfg, clip_cfg, params, FakeTokenizer(),
                        FakeTokenizer(), dtype=jnp.float32)
    host = jax.tree.map(np.asarray, params)
    parts = {}
    for name, cls, cfg, conv in (
            ("transformer", HunyuanVideoTransformer3DModel, HunyuanVideoConfig(**vars(t_cfg)),
             convert.from_jax_hunyuan_transformer),
            ("vae", AutoencoderKLHunyuanVideo, HunyuanVideoVAEConfig(**vars(vae_cfg)),
             convert.from_jax_hunyuan_vae),
            ("text_encoder", LlamaModel, LlamaConfig(**vars(llama_cfg)), convert.from_jax_llama),
            ("text_encoder_2", CLIPTextModel, CLIPTextConfig(**vars(clip_cfg)),
             convert.from_jax_clip_text)):
        parts[name] = cls(cfg).eval()
        parts[name].load_state_dict(conv(host[name], cfg))
    pipe = HunyuanVideoPipeline(**parts, tokenizer=FakeTokenizer(), clip_tokenizer=FakeTokenizer(),
                                dtype=torch.float32, device="cpu")
    return jpipe, pipe


def _latents(seed=0):
    return np.random.default_rng(seed).standard_normal((1, 4, 2, 4, 4)).astype(np.float32)


# the JAX test's call (the template fills the tokenizer's 103 slots: no
# padding), and a prompt without the template that leaves 10 of 16 padded
CALLS = {"template": dict(prompt="a tiny cat", max_sequence_length=8),
         "padded": dict(prompt="a cat", max_sequence_length=16, use_template=False)}


@pytest.mark.parametrize("call", list(CALLS))
def test_pipeline_matches_jax(pipes, call):
    jpipe, pipe = pipes
    args = dict(height=8, width=8, num_frames=5, num_inference_steps=2, guidance_scale=6.0,
                **CALLS[call])
    want = np.asarray(jpipe(**args, latents=jnp.asarray(_latents())))
    want_lat = np.asarray(jpipe(**args, latents=jnp.asarray(_latents()), output_type="latent"))
    for provider in ("flash", "xla"):
        with attention_provider(provider):
            got = pipe(**args, latents=torch.from_numpy(_latents()))
            got_lat = pipe(**args, latents=torch.from_numpy(_latents()), output_type="latent")
        assert got.shape == want.shape == (1, 3, 8, 8, 3)
        np.testing.assert_allclose(got_lat.numpy(), want_lat, atol=LATENT_ATOL, rtol=0)
        np.testing.assert_allclose(got, want, atol=VIDEO_ATOL, rtol=0)
    assert set(pipe.stage_seconds) == {"text_encode", "denoise_steps"}


def test_padded_prompt_leaves_a_ragged_mask(pipes):
    _, pipe = pipes
    with torch.no_grad():
        embeds, mask, pooled = pipe.encode_prompt("a cat", 16, use_template=False)
    assert embeds.shape == (1, 16, 20) and pooled.shape == (1, 16)
    assert mask.sum().item() == 5 and mask[0, :5].all() and not mask[0, 5:].any()


def test_mask_must_be_a_right_padded_prefix(pipes):
    _, pipe = pipes
    pipe.tokenizer = LeftPaddingTokenizer()
    try:
        with pytest.raises(ValueError, match="right-padded prefix"):
            pipe.encode_prompt("a cat", 16, use_template=False)
    finally:
        pipe.tokenizer = FakeTokenizer()


def test_latents_from_a_seeded_generator_and_offload(pipes):
    """Without latents the draw comes from a torch.Generator seeded with
    ``seed``; model offload stages one component at a time and gives the
    same video."""
    _, pipe = pipes
    args = dict(prompt="a cat", height=8, width=8, num_frames=5, num_inference_steps=1,
                max_sequence_length=8, seed=3)
    a = pipe(**args, output_type="latent")
    cfg = pipe.vae.config
    sc, tc = cfg.spatial_compression_ratio, cfg.temporal_compression_ratio
    shape = (1, cfg.latent_channels, (5 - 1) // tc + 1, 8 // sc, 8 // sc)
    drawn = torch.randn(shape, generator=torch.Generator().manual_seed(3), dtype=torch.float32)
    b = pipe(**args, output_type="latent", latents=drawn)
    assert torch.equal(a, b)
    assert not torch.equal(a, pipe(**dict(args, seed=4), output_type="latent"))
    video = pipe(**args)
    pipe.enable_model_offload = True
    try:
        assert np.array_equal(pipe(**args), video)
        assert set(pipe.stage_seconds["staging"]) == {"text_encoder", "text_encoder_2",
                                                      "transformer", "vae"}
    finally:
        pipe.enable_model_offload = False


def test_sigmas_match_jax():
    from vap_tpu.pipelines.hunyuan_video import shift_sigmas_constant as jax_shift

    np.testing.assert_allclose(shift_sigmas_constant(np.array([0.5]), 7.0), 3.5 / 4.0, atol=1e-12)
    sig = np.linspace(1.0, 0.0, 51)[:-1]
    want = np.append(jax_shift(sig, 7.0), 0.0).astype(np.float32)
    np.testing.assert_array_equal(flow_sigmas(50, 7.0), want)


def test_pipeline_without_device_needs_a_card(pipes):
    _, pipe = pipes
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HunyuanVideoPipeline(pipe.transformer, pipe.vae, pipe.text_encoder, pipe.text_encoder_2,
                             FakeTokenizer())
