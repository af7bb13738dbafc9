"""The slice as a whole: the port's CogVideoX VAP pipeline against the JAX
pipeline on the same weights and inputs.

Tiny transformer (three blocks, MoT in 0-1, learned position embedding),
tiny T5 and VAE; a 64x64 image, a 9-frame reference video, the same prompts
through one fake tokenizer, and the same starting latents. DDIM, 3 steps,
dynamic CFG at guidance 6, CFG batch 2. All weights come from the JAX
package's native initializers and reach the port through ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxMOTConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu.models.cogvideox.vae import CogVideoXVAEConfig as JaxVAEConfig
from vap_tpu.models.cogvideox.vae import init_cogvideox_vae
from vap_tpu.models.cogvideox.vae_weights import convert_cogvideox_vae_state_dict
from vap_tpu.models.text_encoders import T5Config as JaxT5Config
from vap_tpu.models.text_encoders import init_t5_encoder
from vap_tpu.pipelines import cogvideox_i2v_mot as jpipe
from vap_tpu_torch import convert
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
from vap_tpu_torch.pipelines import cogvideox_i2v_mot as tpipe

T_CFG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
             use_learned_positional_embeddings=True)
H = W = 64
F = 9


class FakeTokenizer:
    """Deterministic character ids, padded to max_length."""

    def __call__(self, texts, padding=None, max_length=16, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:max_length]):
                ids[i, j] = (ord(ch) * 7 + j) % 127 + 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


def _vae_pair_inverted_scale():
    """Port-made VAE weights read into JAX by the JAX package's converter."""
    vae_cfg = CogVideoXVAEConfig.tiny(invert_scale_latents=True)
    jvae_cfg = JaxVAEConfig.tiny(invert_scale_latents=True)
    torch.manual_seed(0)
    vae = AutoencoderKLCogVideoX(vae_cfg).eval()
    jparams = convert_cogvideox_vae_state_dict(
        {k: v.numpy() for k, v in vae.state_dict().items()}, jvae_cfg)
    return vae, jparams, jvae_cfg


def build_pipelines():
    """(port, ref): the two pipelines on the same natively initialised
    tiny weights."""
    key = jax.random.PRNGKey(0)
    t_cfg, jt_cfg = CogVideoXMOTConfig.tiny(**T_CFG), JaxMOTConfig.tiny(**T_CFG)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    jtxt_cfg = JaxT5Config.tiny(d_model=t_cfg.text_embed_dim)
    vae_cfg, jvae_cfg = CogVideoXVAEConfig.tiny(), JaxVAEConfig.tiny()
    jparams_t = init_cogvideox_mot(key, jt_cfg)
    jparams_txt = init_t5_encoder(key, jtxt_cfg)
    jparams_vae = jax.jit(init_cogvideox_vae, static_argnums=1)(key, jvae_cfg)
    transformer = CogVideoXTransformer3DMOTModel(t_cfg).eval()
    transformer.load_state_dict(convert.from_jax_transformer(jax.tree.map(np.asarray, jparams_t), t_cfg))
    text_encoder = T5EncoderModel(txt_cfg).eval()
    text_encoder.load_state_dict(convert.from_jax_t5(jax.tree.map(np.asarray, jparams_txt), txt_cfg))
    vae = AutoencoderKLCogVideoX(vae_cfg).eval()
    vae.load_state_dict(convert.from_jax_vae(jax.tree.map(np.asarray, jparams_vae), vae_cfg))

    port = tpipe.CogVideoXVAPPipeline(transformer, vae, text_encoder, FakeTokenizer(),
                                      dtype=torch.float32, device="cpu")
    ref = jpipe.CogVideoXVAPPipeline(
        transformer_cfg=jt_cfg, vae_cfg=jvae_cfg, text_cfg=jtxt_cfg,
        params={"transformer": jparams_t, "vae": jparams_vae, "text_encoder": jparams_txt},
        tokenizer=FakeTokenizer(), dtype=jnp.float32)
    return port, ref


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines()


def _call_args():
    rng = np.random.default_rng(0)
    return dict(
        image=rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
        prompt="a cat", ref_videos=[rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32)],
        prompt_mot_ref=["explode it"], height=H, width=W, num_frames=F,
        num_inference_steps=3, guidance_scale=6.0, use_dynamic_cfg=True,
        max_sequence_length=6,
    ), rng.standard_normal((1, 3, 4, H // 8, W // 8)).astype(np.float32)


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_pipeline_matches_jax(pipelines, output_type):
    port, ref = pipelines
    args, latents = _call_args()
    want = np.asarray(ref(**args, latents=jnp.asarray(latents), output_type=output_type))
    got = port(**args, latents=torch.from_numpy(latents), output_type=output_type)
    got = got.numpy() if output_type == "latent" else got
    assert got.shape == want.shape == ((1, 3, 4, 8, 8) if output_type == "latent"
                                       else (1, F, H, W, 3))
    assert np.isfinite(got).all()
    # float32 end to end: T5, three VAE encodes, 3 denoise steps of three
    # blocks at CFG 2 and a decode; the two frameworks sum in other orders
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    assert len(port.stage_seconds["denoise_steps"]) == 3


@pytest.mark.parametrize("mode", ["first", "evenly"])
def test_select_frames_matches_jax(mode):
    frames = list(range(23))
    assert tpipe.select_frames(frames, 9, mode) == jpipe.select_frames(frames, 9, mode)


def test_dynamic_cfg_is_float64():
    """ROADMAP Queue 3 "dynamic-CFG cosine": the schedule equals the JAX
    one, which a float32 evaluation of the same formula does not."""
    ts = np.array([999, 666, 333], np.float32)
    got = tpipe.dynamic_cfg_schedule(ts, 6.0, 3)
    np.testing.assert_array_equal(got, jpipe.dynamic_cfg_schedule(ts, 6.0, 3))
    f32 = np.float32
    naive = 1 + f32(6.0) * ((1 - np.cos(f32(np.pi) * ((f32(3) - ts) / f32(3)) ** f32(5))) / 2)
    assert np.abs(naive - got).max() > 1.0


def test_invert_scale_latents_only_on_image_latents():
    """ROADMAP Queue 3 / ``cogvideox_i2v_mot.py:86-94``: under
    invert_scale_latents the image-conditioning latents stay unscaled, the
    reference-video latents keep the scaling factor, as in JAX."""
    vae, jparams, jvae_cfg = _vae_pair_inverted_scale()
    port = tpipe.CogVideoXVAPPipeline(None, vae, None, dtype=torch.float32, device="cpu")
    ref = jpipe.CogVideoXVAPPipeline(transformer_cfg=None, vae_cfg=jvae_cfg, text_cfg=None,
                                     params={"vae": jparams}, dtype=jnp.float32)
    video = np.random.default_rng(1).uniform(-1, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        img = port._vae_encode_mode(torch.from_numpy(video), image_cond=True)
        vid = port._vae_encode_mode(torch.from_numpy(video), image_cond=False)
    factor = port.vae.config.scaling_factor
    torch.testing.assert_close(vid, img * factor, atol=1e-6, rtol=1e-6)
    for got, image_cond in ((img, True), (vid, False)):
        want = ref._vae_encode_mode(jnp.asarray(video), image_cond=image_cond)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-5)


def test_unported_modes_raise(pipelines):
    """What the port still lacks raises: streamed block offload, CogVideoX
    1.5's temporal patching and the MoT options of the transformer."""
    port, _ = pipelines
    args, _ = _call_args()
    streamed = tpipe.CogVideoXVAPPipeline(port.transformer, port.vae, port.text_encoder,
                                          FakeTokenizer(), dtype=torch.float32, device="cpu",
                                          offload_blocks_chunk=2)
    with pytest.raises(NotImplementedError, match="offload_blocks_chunk"):
        streamed(**args)
    for option in (dict(patch_size_t=2), dict(ofs_embed_dim=8),
                   dict(reference_train_mode="reference_independent"),
                   dict(ablation_single_encoder=True), dict(ablation_residual_addition=True)):
        with pytest.raises(NotImplementedError):
            CogVideoXTransformer3DMOTModel(CogVideoXMOTConfig.tiny(**{**T_CFG, **option}))


def test_pipeline_without_device_needs_a_card(monkeypatch):
    """No ``device`` means the card: on a box without CUDA the constructor
    raises instead of running on the CPU; ``device="cpu"`` is the way there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.CogVideoXVAPPipeline(None, None, None)
    assert tpipe.CogVideoXVAPPipeline(None, None, None, device="cpu").device == torch.device("cpu")
