"""The port's RoPE, norms, timestep embedding, T5 encoder and CogVideoX VAE
against the JAX package, on the same numpy inputs and the same weights.

The T5 and VAE weights are made by the port (torch's initializers) and
carried into JAX by the JAX package's own checkpoint converters, which read
diffusers / HF keys: this checks the port's module names against them. (The
JAX initializer of the VAE alone takes ~15 s on one CPU core.) The
``convert.from_jax_*`` functions are held to the exact inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.models import common as jcommon
from vap_tpu.models.cogvideox import vae as jvae
from vap_tpu.models.cogvideox.vae_weights import convert_cogvideox_vae_state_dict
from vap_tpu.models.text_encoders import t5 as jt5
from vap_tpu.ops import rope as jrope
from vap_tpu_torch import convert
from vap_tpu_torch.models import common as tcommon
from vap_tpu_torch.models.cogvideox import vae as tvae
from vap_tpu_torch.models.text_encoders import t5 as tt5
from vap_tpu_torch.ops import rope as trope

# float32 on both sides; the differences are summation order and libm
ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd_np(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _assert_same_state(sd, module):
    ref = module.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        torch.testing.assert_close(sd[k], v, atol=0, rtol=0, msg=k)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_kwargs(mot_num):
    return dict(attention_head_dim=16, patch_size=2, sample_width=90, sample_height=60,
                mot_num=mot_num)


@pytest.mark.parametrize("mot_num", [0, 1, 2])
def test_rope_tables_match_jax(mot_num):
    cos, sin = trope.prepare_cogvideox_rotary_embeddings(64, 96, 3, **_rope_kwargs(mot_num))
    jcos, jsin = jrope.prepare_cogvideox_rotary_embeddings(
        64, 96, 3, patch_size_t=None, **_rope_kwargs(mot_num))
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def test_ref_rope_places_references_at_negative_times():
    """The first temporal frequency is 1, so sin of column 0 is sin(t): the
    last reference frame sits at t = -1 and the target's first at t = 0."""
    f, hw = 3, (64 // 16) * (96 // 16)
    _, sin_ref = trope.prepare_cogvideox_rotary_embeddings(64, 96, f, **_rope_kwargs(2))
    _, sin_tgt = trope.prepare_cogvideox_rotary_embeddings(64, 96, f, **_rope_kwargs(0))
    assert sin_ref.shape[0] == 2 * f * hw
    np.testing.assert_allclose(sin_ref[-1, 0].item(), np.sin(-1.0), atol=1e-6)
    assert sin_ref[0, 0].item() == pytest.approx(np.sin(-2 * f), abs=1e-6)
    assert sin_tgt[0, 0].item() == 0.0


def test_apply_rotary_emb_matches_jax():
    x = _rng(0).standard_normal((2, 3, 10, 16), np.float32)
    ang = _rng(1).uniform(-3, 3, (10, 8)).astype(np.float32)
    cos, sin = np.repeat(np.cos(ang), 2, 1), np.repeat(np.sin(ang), 2, 1)
    ref = jrope.apply_rotary_emb(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = trope.apply_rotary_emb(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# norms and timestep embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_jax(norm, dtype):
    x = _rng(2).standard_normal((3, 7, 32), np.float32) * 3 + 1
    w = _rng(3).standard_normal(32).astype(np.float32)
    b = _rng(4).standard_normal(32).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    if norm == "layer_norm":
        ref = jcommon.layer_norm({"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                                 jnp.asarray(x, dtype), 1e-5)
        got = tcommon.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    else:
        ref = jcommon.rms_norm({"scale": jnp.asarray(w)}, jnp.asarray(x, dtype), 1e-6)
        got = tcommon.rms_norm(xt, torch.from_numpy(w), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # bf16: both round the same f32 value once
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=ATOL if dtype == "float32" else 2e-2, rtol=0)


def test_timestep_embedding_matches_jax():
    t = np.array([999.0, 500.5, 0.0], np.float32)
    ref_emb = jcommon.sinusoidal_timestep_embedding(jnp.asarray(t), 32)
    emb = tcommon.sinusoidal_timestep_embedding(torch.from_numpy(t), 32)
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb), atol=1e-5, rtol=0)

    p = jcommon.init_timestep_embedding_mlp(jax.random.PRNGKey(0), 32, 16)
    mlp = tcommon.TimestepEmbedding(32, 16)
    sd = {}
    for name in ("linear_1", "linear_2"):
        convert._linear(sd, name, _np(p[name]))
    mlp.load_state_dict(sd)
    ref = jcommon.timestep_embedding_mlp(p, ref_emb)
    with torch.no_grad():
        got = mlp(emb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------

def test_t5_encode_matches_jax():
    cfg = tt5.T5Config.tiny(d_model=16)
    torch.manual_seed(0)
    model = tt5.T5EncoderModel(cfg)
    jparams = jt5.convert_t5_state_dict(_sd_np(model), jt5.T5Config.tiny(d_model=16))
    _assert_same_state(convert.from_jax_t5(_np(jparams), cfg), model)
    ids = _rng(5).integers(0, cfg.vocab_size, (2, 40))
    ref = jt5.t5_encode(jparams, jt5.T5Config.tiny(d_model=16), jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_pair():
    cfg = tvae.CogVideoXVAEConfig.tiny()
    jcfg = jvae.CogVideoXVAEConfig.tiny()
    torch.manual_seed(0)
    model = tvae.AutoencoderKLCogVideoX(cfg)
    jparams = convert_cogvideox_vae_state_dict(_sd_np(model), jcfg)
    return model, jparams, jcfg


def test_vae_converts_both_ways(vae_pair):
    model, jparams, jcfg = vae_pair
    _assert_same_state(convert.from_jax_vae(_np(jparams), model.config), model)


@pytest.mark.parametrize("frames", [1, 9])
def test_vae_encode_matches_jax(vae_pair, frames):
    model, jparams, jcfg = vae_pair
    video = _rng(frames).uniform(-1, 1, (1, frames, 16, 24, 3)).astype(np.float32)
    encode = jax.jit(jvae.vae_encode, static_argnums=1)
    ref = jvae.posterior_mode(encode(jparams, jcfg, jnp.asarray(video)))
    with torch.no_grad():
        got = tvae.posterior_mode(tvae.vae_encode(model, torch.from_numpy(video)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("n_splits", [1, 2])
def test_vae_decode_matches_jax(vae_pair, n_splits):
    """Streamed decode (n_splits=1) and the W-split decode with its blended
    seam, 3 latent frames (chunks of 2 with the conv cache carried)."""
    model, jparams, jcfg = vae_pair
    z = _rng(6).standard_normal((1, 3, 4, 12, 4)).astype(np.float32)
    ref = jvae.vae_decode_wsplit(jparams, jcfg, jnp.asarray(z), n_splits)
    with torch.no_grad():
        got = tvae.vae_decode_wsplit(model, torch.from_numpy(z), n_splits)
    assert got.shape == (1, 9, 32, 96, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-5)


def test_vae_decode_frame_batch_pinned(vae_pair):
    """ROADMAP Queue 3 "VAE chunking": below 2 the decode would drop frames,
    so it raises (as ``vae.py:413`` does); the batch size is semantic."""
    model = vae_pair[0]
    z = torch.from_numpy(_rng(7).standard_normal((1, 5, 4, 4, 4)).astype(np.float32))
    for fn in (tvae.vae_decode_streamed, tvae.vae_decode_wsplit):
        with pytest.raises(ValueError, match="frame_batch >= 2"):
            fn(model, z, frame_batch=1)
    with torch.no_grad():
        two = tvae.vae_decode_streamed(model, z, frame_batch=2)
        five = tvae.vae_decode_streamed(model, z, frame_batch=5)
    assert two.shape == five.shape == (1, 17, 32, 32, 3)
    assert (two - five).abs().max() > 1e-4


def test_vae_tf32_off_only_inside_encode_and_decode(vae_pair):
    """The VAE turns TF32 off for its float32 convs while it runs, and gives
    both process-wide flags back afterwards."""
    model = vae_pair[0]
    seen = []

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    hooks = [m.register_forward_pre_hook(lambda *_: seen.append(flags()))
             for m in (model.encoder, model.decoder)]
    prev = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            tvae.vae_encode(model, torch.zeros((1, 1, 16, 16, 3)))
            tvae.vae_decode_wsplit(model, torch.zeros((1, 1, 2, 2, 4)), 1)
        assert seen == [(False, False)] * 2
        assert flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        for h in hooks:
            h.remove()
