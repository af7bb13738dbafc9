"""The Wan slice as a whole: the port's WanVAPPipeline against the JAX
pipeline on the same weights and inputs.

Tiny MoT transformer (2 blocks, MoT in both, 12-channel conditioning for the
4-channel tiny VAE), tiny UMT5 (a bias table per layer), tiny CLIP vision
and the tiny Wan VAE; a 32x32 image, a 9-frame reference video, the same
prompts through one fake tokenizer (padding masked), the same starting
latents. FlowMatch Euler, shift 3, 3 steps, guidance 5, CFG batch 2. All
weights come from the JAX package's native initializers, jittered so no bias
is zero, and reach the port through ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.models.text_encoders import clip_vision as jclip
from vap_tpu.models.text_encoders import t5 as jt5
from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan import vae as jvae
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.pipelines import wan_i2v_mot as jpipe
from vap_tpu_torch import convert
from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
from vap_tpu_torch.pipelines import wan_i2v_mot as tpipe

H = W = 32
F = 9
T_CFG = dict(in_channels=12, out_channels=4, text_dim=32, image_dim=24)


class FakeTokenizer:
    """Deterministic character ids, padded to max_length with 0 (masked)."""

    def __call__(self, texts, padding=None, max_length=8, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:max_length]):
                ids[i, j] = (ord(ch) * 7 + j) % 127 + 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


def _jitter(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def pipelines():
    key = jax.random.PRNGKey(0)
    t_cfg, jt_cfg = WanMOTConfig.tiny(**T_CFG), JaxWanConfig.tiny(**T_CFG)
    txt_cfg = T5Config.tiny(per_layer_relative_bias=True)
    jtxt_cfg = jt5.T5Config.tiny(per_layer_relative_bias=True)
    clip_cfg, jclip_cfg = CLIPVisionConfig.tiny(), jclip.CLIPVisionConfig.tiny()
    vae_cfg, jvae_cfg = WanVAEConfig.tiny(), jvae.WanVAEConfig.tiny()
    params = {
        "transformer": _jitter(jwan.init_wan_mot(key, jt_cfg), 0),
        "text_encoder": _jitter(jt5.init_t5_encoder(key, jtxt_cfg), 1),
        "image_encoder": _jitter(jclip.init_clip_vision(key, jclip_cfg), 2),
        "vae": _jitter(jax.jit(jvae.init_wan_vae, static_argnums=1)(key, jvae_cfg), 3),
    }
    modules = {
        "transformer": (WanTransformer3DMOTModel(t_cfg), convert.from_jax_wan_transformer, t_cfg),
        "text_encoder": (T5EncoderModel(txt_cfg), convert.from_jax_t5, txt_cfg),
        "image_encoder": (CLIPVisionModel(clip_cfg), convert.from_jax_clip_vision, clip_cfg),
        "vae": (AutoencoderKLWan(vae_cfg), convert.from_jax_wan_vae, vae_cfg),
    }
    for name, (module, conv, cfg) in modules.items():
        module.load_state_dict(conv(params[name], cfg))
        module.eval()

    def port(**kw):
        return tpipe.WanVAPPipeline(**{n: m for n, (m, _, _) in modules.items()},
                                    tokenizer=FakeTokenizer(), dtype=torch.float32,
                                    device="cpu", **kw)

    ref = jpipe.WanVAPPipeline(
        transformer_cfg=jt_cfg, vae_cfg=jvae_cfg, text_cfg=jtxt_cfg, clip_cfg=jclip_cfg,
        params=jax.tree.map(jnp.asarray, params), tokenizer=FakeTokenizer(), dtype=jnp.float32)
    return port, ref


def _call_args():
    rng = np.random.default_rng(0)
    return dict(
        image=rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
        prompt="a cat", ref_videos=[rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32)],
        prompt_mot_ref=["explode it"], height=H, width=W, num_frames=F,
        num_inference_steps=3, guidance_scale=5.0, max_sequence_length=8,
    ), rng.standard_normal((1, 3, H // 8, W // 8, 4)).astype(np.float32)


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_wan_pipeline_matches_jax(pipelines, output_type):
    port, ref = pipelines
    args, latents = _call_args()
    want = np.asarray(ref(**args, latents=jnp.asarray(latents), output_type=output_type))
    pipe = port()
    got = pipe(**args, latents=torch.from_numpy(latents), output_type=output_type)
    got = got.numpy() if output_type == "latent" else got
    assert got.shape == want.shape == ((1, 3, 4, 4, 4) if output_type == "latent"
                                       else (1, F, H, W, 3))
    assert np.isfinite(got).all()
    # float32 end to end: UMT5, two CLIP encodes, three VAE encodes, 3 steps
    # of two MoT blocks at CFG 2 (guidance 5 amplifies the branch difference)
    # and a streamed decode; the two frameworks sum in other orders
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)
    assert len(pipe.stage_seconds["denoise_steps"]) == 3


def test_wan_pipeline_offload_equals_resident(pipelines):
    """With enable_model_offload one component at a time is staged (here on
    the CPU, which is also where the weights live): the result is the same,
    to the bit, and each component was staged."""
    port, _ = pipelines
    args, latents = _call_args()
    resident = port()(**args, latents=torch.from_numpy(latents), output_type="np")
    pipe = port(enable_model_offload=True)
    offloaded = pipe(**args, latents=torch.from_numpy(latents), output_type="np")
    np.testing.assert_array_equal(offloaded, resident)
    assert set(pipe.stage_seconds["staging"]) == {"text_encoder", "image_encoder", "vae",
                                                  "transformer"}
    assert len(pipe._staged) == 1  # at most one component staged at a time


def test_make_i2v_mask_matches_jax():
    np.testing.assert_array_equal(tpipe.make_i2v_mask(1, 9, 2, 3), jpipe.make_i2v_mask(1, 9, 2, 3))


def test_clip_preprocess_matches_jax(pipelines):
    port, ref = pipelines
    image = np.random.default_rng(9).uniform(-1, 1, (48, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(port().clip_preprocess(image).numpy(),
                               np.asarray(ref._clip_preprocess(image)), atol=1e-5, rtol=0)


def test_pipeline_without_device_needs_a_card(monkeypatch):
    """No ``device`` means the card: without one the constructor raises
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.WanVAPPipeline(None, None, None, None)
