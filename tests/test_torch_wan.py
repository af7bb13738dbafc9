"""The port's Wan2.1 modules against the JAX package, each at a tiny size.

Every module gets the same numpy inputs and the same weights: the JAX
package's native initializers, jittered by a seeded normal so that no bias
is zero and no norm weight is one, carried into the port by ``convert``.
The JAX side runs the way its own tests run it (the ``xla`` attention
provider, set by ``tests/conftest.py``); the port's attention wrappers run
their plain versions on CPU tensors. All comparisons are float32.
"""

import cv2
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
from vap_tpu.ops.schedulers import FlowMatchEulerScheduler as JaxFlowMatch
from vap_tpu_torch import convert
from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
from vap_tpu_torch.models.wan import transformer_mot as twan
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.vae import (AutoencoderKLWan, WanVAEConfig, wan_vae_decode_streamed,
                                          wan_vae_encode)
from vap_tpu_torch.ops.schedulers import FlowMatchEulerScheduler
from vap_tpu_torch.pipelines.wan_i2v_mot import resize_frame

# float32 on both sides; only the summation order differs (XLA's fused
# contractions against PyTorch's), a few ulps of values of order 1-5
ATOL = 2e-5


def jitter(tree, seed):
    """Every leaf plus 0.05 * a seeded normal, as numpy float32."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("negative_time", [False, True], ids=["target", "reference"])
@pytest.mark.parametrize("head_dim", [12, 128])
def test_wan_rope_tables_match_jax(head_dim, negative_time):
    """The reference table puts its frames at negative times (-F..-1)."""
    kw = dict(negative_time=True, total_ref_frames=6) if negative_time else {}
    cfg, jcfg = WanMOTConfig.tiny(attention_head_dim=head_dim), JaxWanConfig.tiny(attention_head_dim=head_dim)
    cos, sin = twan.wan_rope(cfg, 6, 3, 4, **kw)
    jcos, jsin = jwan.wan_rope(jcfg, 6, 3, 4, **kw)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    if negative_time:  # the reference's first frame sits at t = -6, not at 0
        base, _ = twan.wan_rope(cfg, 6, 3, 4)
        assert not torch.equal(cos, base)


def test_apply_wan_rope_is_interleaved_and_matches_jax():
    """Wan rotates (even, odd) pairs, not CogVideoX's halves."""
    cfg = WanMOTConfig.tiny(attention_head_dim=128)
    cos, sin = twan.wan_rope(cfg, 2, 3, 4, negative_time=True, total_ref_frames=2)
    x = np.random.default_rng(0).standard_normal((2, 3, 24, 128)).astype(np.float32)
    got = twan.apply_wan_rope(torch.from_numpy(x), cos, sin).numpy()
    want = np.asarray(jwan.apply_wan_rope(jnp.asarray(x), jnp.asarray(cos.numpy()),
                                          jnp.asarray(sin.numpy())))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    c, s = cos.numpy()[:, 0], sin.numpy()[:, 0]  # the first pair: dims 0 and 1
    np.testing.assert_allclose(got[..., 1], x[..., 0] * s + x[..., 1] * c, atol=1e-6)


def test_umt5_encode_with_padding_mask_matches_jax():
    """UMT5: one relative-bias table per layer and a -1e9 key mask on the
    padded positions (``t5.py:135-146``)."""
    cfg, jcfg = T5Config.tiny(per_layer_relative_bias=True), jt5.T5Config.tiny(per_layer_relative_bias=True)
    params = jitter(jt5.init_t5_encoder(jax.random.PRNGKey(2), jcfg), 2)
    model = T5EncoderModel(cfg).eval()
    model.load_state_dict(convert.from_jax_t5(params, cfg))
    rng = np.random.default_rng(3)
    ids = rng.integers(1, cfg.vocab_size, (2, 9))
    mask = np.ones((2, 9), np.int64)
    mask[0, 5:] = 0
    mask[1, 7:] = 0
    want = np.asarray(jt5.t5_encode(jax_tree(params), jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        unmasked = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(unmasked[0] - got[0]).max() > 1e-3  # the mask is applied
    tables = [model.encoder.block[i].layer[0].SelfAttention.relative_attention_bias.weight
              for i in range(cfg.num_layers)]
    assert not torch.equal(tables[0], tables[1])  # a table per layer


def test_clip_vision_encode_matches_jax():
    cfg, jcfg = CLIPVisionConfig.tiny(), jclip.CLIPVisionConfig.tiny()
    params = jitter(jclip.init_clip_vision(jax.random.PRNGKey(1), jcfg), 1)
    model = CLIPVisionModel(cfg).eval()
    model.load_state_dict(convert.from_jax_clip_vision(params, cfg))
    px = np.random.default_rng(4).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jclip.clip_vision_encode(jax_tree(params), jcfg, jnp.asarray(px)))
    with torch.no_grad():
        got = model(torch.from_numpy(px)).numpy()
    assert got.shape == (2, cfg.num_positions, cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("src,dst", [((480, 832), (224, 224)), ((64, 64), (28, 28)),
                                     ((50, 40), (28, 28)), ((20, 30), (28, 28)),
                                     ((28, 28), (28, 28)), ((300, 200), (224, 224)),
                                     ((57, 30), (40, 61)), ((480, 100), (224, 224))])
def test_resize_matches_cv2(src, dst):
    """The CLIP resize: cv2 INTER_AREA when the height shrinks (partial
    pixels weighted by their overlap at a non-integer ratio; with a width
    that grows, cv2's two-tap area-mode weights on both axes), else
    INTER_LINEAR with half-pixel centres. cv2 sums in float32: 1e-6."""
    img = np.random.default_rng(sum(src)).uniform(0, 1, (*src, 3)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA if src[0] > dst[0]
                      else cv2.INTER_LINEAR)
    np.testing.assert_allclose(resize_frame(img, *dst), want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def wan_vae():
    cfg, jcfg = WanVAEConfig.tiny(), jvae.WanVAEConfig.tiny()
    params = jitter(jax.jit(jvae.init_wan_vae, static_argnums=1)(jax.random.PRNGKey(0), jcfg), 0)
    vae = AutoencoderKLWan(cfg).eval()
    vae.load_state_dict(convert.from_jax_wan_vae(params, cfg))
    return vae, jax_tree(params), jcfg


@pytest.mark.parametrize("frames", [5, 9])
def test_wan_vae_encode_matches_jax(wan_vae, frames):
    """Chunks of [1, 4] and [1, 4, 4] frames through the feature cache."""
    vae, params, jcfg = wan_vae
    x = np.random.default_rng(frames).uniform(-1, 1, (1, frames, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvae.wan_vae_encode(params, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = wan_vae_encode(vae, torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1 + (frames - 1) // 4, 4, 4, 2 * jcfg.z_dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_wan_vae_decode_streamed_matches_jax(wan_vae):
    """Three latent frames, one decoder step each: the first skips the
    upsamplers' time conv (the Rep sentinel), the later ones use the cache."""
    vae, params, jcfg = wan_vae
    z = np.random.default_rng(7).standard_normal((1, 3, 4, 4, jcfg.z_dim)).astype(np.float32)
    want = np.asarray(jvae.wan_vae_decode_streamed(params, jcfg, jnp.asarray(z)))
    with torch.no_grad():
        got = wan_vae_decode_streamed(vae, torch.from_numpy(z)).numpy()
    assert got.shape == (1, 9, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_flow_match_sigmas_timesteps_and_step_match_jax():
    ours, ref = FlowMatchEulerScheduler(shift=3.0), JaxFlowMatch(shift=3.0)
    for n in (3, 50):
        np.testing.assert_array_equal(ours.sigmas(n), ref.sigmas(n))
        np.testing.assert_array_equal(ours.timesteps(n), ref.timesteps(n))
    rng = np.random.default_rng(5)
    x, v = (rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    sig = ours.sigmas(3)
    got = ours.step(torch.from_numpy(v), torch.from_numpy(x), sig[0], sig[1]).numpy()
    want = np.asarray(ref.step(jnp.asarray(v), jnp.asarray(x), sig[0], sig[1]))
    np.testing.assert_array_equal(got, want)  # one f32 multiply-add on both sides


@pytest.mark.parametrize("num_refs", [1, 2])
def test_wan_mot_forward_matches_jax(num_refs):
    """The tiny MoT transformer (2 blocks, MoT in both) with one and with
    two references, each attending only to its own context."""
    cfg, jcfg = WanMOTConfig.tiny(), JaxWanConfig.tiny()
    params = jitter(jwan.init_wan_mot(jax.random.PRNGKey(0), jcfg), num_refs)
    model = twan.WanTransformer3DMOTModel(cfg).eval()
    model.load_state_dict(convert.from_jax_wan_transformer(params, cfg))
    rng = np.random.default_rng(10 + num_refs)
    b, f, h, w, r = 2, 2, 8, 8, num_refs
    args = [rng.standard_normal((b, f, h, w, cfg.in_channels)).astype(np.float32),
            np.array([500.0, 700.0], np.float32),
            rng.standard_normal((b, 7, cfg.text_dim)).astype(np.float32),
            rng.standard_normal((b, 5, cfg.image_dim)).astype(np.float32),
            rng.standard_normal((b, r * f, h, w, cfg.in_channels)).astype(np.float32),
            np.ones((b, r), np.float32),
            rng.standard_normal((b, r * 7, cfg.text_dim)).astype(np.float32),
            rng.standard_normal((b, r * 5, cfg.image_dim)).astype(np.float32)]
    names = ("hidden_states", "timestep", "encoder_hidden_states", "encoder_hidden_states_image",
             "hidden_states_mot_ref", "timestep_mot_ref", "encoder_hidden_states_mot_ref",
             "encoder_hidden_states_image_mot_ref")
    want, _ = jwan.wan_mot_forward(jax_tree(params), jcfg, num_mot_ref=r,
                                   **{n: jnp.asarray(a) for n, a in zip(names, args)})
    with torch.no_grad():
        got = model(**{n: torch.from_numpy(a) for n, a in zip(names, args)}, num_mot_ref=r)
    assert got.shape == (b, f, h, w, cfg.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
