"""K2's dispatch and the arithmetic its card kernels rest on, against the
JAX package's int8 recipe.

The CUDA kernels (the pre-pass ``csrc/sage_quant.cu`` and the forwards
``csrc/sage_fwd_sm90*.cu``, ``csrc/sage_fwd.cu``) run only on the card
(``test_torch_gpu.py``, ``chip_smoke.py``). Here: which source, entry and
launch counter a CUDA call takes at each head_dim; the pre-pass kernel's
one-pass smoothed abs-max, max|k - mean| = max over d of max(kmax[d] -
mean[d], mean[d] - kmin[d]), against ``sage_quantize`` (the plain version)
and against the recipe of ``_flash_attention_forward_t_i8`` (:835-852)
written in jax.numpy; and the forwards' int32 -> f32 conversion without the
conversion unit, exact up to |x| = D * 127^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu_torch.ops import _build
from vap_tpu_torch.ops import flash_attention as tfa

SQ, SKV = 70, 300  # a K longer than Q, as at Wan's joint shape over its cross keys


@pytest.mark.parametrize("varlen", [False, True], ids=["fixed", "kv_lens"])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_sage_entry_dispatch(d, varlen):
    """Head_dim 64 and 128 take the wgmma kernels (counter ``launches``), 32
    and 96 the mma.sync kernel of sage_fwd.cu (``launches_mma``), with or
    without kv_lens (``_varlen``); every entry named has a C signature in
    ``_build.SOURCES`` and its counter exists on the wrapper."""
    source, entry, counter = tfa.sage_entry(d, varlen)
    want = {64: ("sage_fwd_sm90_d64", "vap_sage_fwd_d64", "launches"),
            128: ("sage_fwd_sm90", "vap_sage_fwd_d128", "launches")}.get(
        d, ("sage_fwd", "vap_sage_fwd", "launches_mma"))
    assert (source, entry, counter) == want[:2] + (want[2] + ("_varlen" if varlen else ""),)
    assert entry in _build.SOURCES[source]
    assert isinstance(getattr(tfa.flash_attention_int8_forward, counter), int)
    # the wgmma entries take no head_dim argument; the mma.sync one does
    n_args = len(_build.SOURCES[source][entry])
    assert n_args == (13 if source == "sage_fwd" else 12)
    assert "vap_sage_quant" in _build.SOURCES["sage_quant"]


def _inputs(seed, d, lens, nan_suffix):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(lens), 3, SQ, d)).astype(np.float32)
    k = (rng.standard_normal((len(lens), 3, SKV, d)) * rng.uniform(0.5, 2.0, d)
         + rng.standard_normal(d)).astype(np.float32)  # a per-channel offset, as K smoothing meets
    if nan_suffix:
        pad = np.arange(SKV)[None, :] >= np.asarray(lens)[:, None]
        k = np.where(pad[:, None, :, None], np.float32(np.nan), k)
    return q, k


def _one_pass_scales(q, k, lens):
    """s_q and s_k as the pre-pass kernel takes them: one pass over k for
    the per-d sum, max and min (rows past the length selected to 0), then
    the smoothed abs-max from those alone."""
    keep = torch.arange(k.shape[2])[None, :] < torch.as_tensor(lens)[:, None]  # [B, Skv]
    kz = torch.where(keep[:, None, :, None], k, torch.zeros(()))
    mean = kz.sum(dim=2) / k.shape[2]  # [B, H, D]
    kmax, kmin = kz.amax(dim=2), kz.amin(dim=2)
    smoothed = torch.maximum(kmax - mean, mean - kmin).amax(dim=-1)  # [B, H]
    s_q = (q.abs().amax(dim=(2, 3)) / 127.0).clamp_min(1e-8)
    return s_q, (smoothed / 127.0).clamp_min(1e-8), mean


@pytest.mark.parametrize("nan_suffix", [False, True], ids=["zeros", "nan_suffix"])
@pytest.mark.parametrize("d", [64, 128])
def test_one_pass_smoothed_absmax_matches_sage_quantize(d, nan_suffix):
    """Lengths Skv, Skv - 37 and 0 (the last with every key past it): the
    one-pass identity gives the plain version's s_q to the bit and its s_k to
    the bit where the mean is the same (here taken over the same rows, so
    only its summation order differs: within 1e-6); a NaN suffix past the
    lengths reaches neither."""
    lens = [SKV, SKV - 37, 0]
    q, k = map(torch.from_numpy, _inputs(d, d, lens, nan_suffix))
    s_q, s_k, mean = _one_pass_scales(q, k, lens)
    q_i8, k_i8, sqk = tfa.sage_quantize(q, k, d ** -0.5, torch.tensor(lens))
    assert torch.isfinite(s_k).all() and torch.isfinite(sqk).all()
    # sage_quantize's s_q is recovered from its q_i8 and sqk only up to
    # rounding, so recompute it the plain way and compare the bits
    ref_s_q = (q.abs().amax(dim=(2, 3)) / 127.0).clamp_min(1e-8)
    assert torch.equal(s_q, ref_s_q)
    # s_k from the two-pass recipe (smooth, then max|.|) with the same mean
    keep = torch.arange(SKV)[None, :] < torch.tensor(lens)[:, None]
    kz = torch.where(keep[:, None, :, None], k, torch.zeros(()))
    two_pass = ((kz - mean[:, :, None, :]).abs().amax(dim=(2, 3)) / 127.0).clamp_min(1e-8)
    assert torch.equal(s_k, two_pass)  # the identity is exact in f32
    torch.testing.assert_close(sqk, s_q * s_k * d ** -0.5 * tfa.LOG2_E, rtol=1e-6, atol=0)
    # the sample with no valid key: every row 0, mean 0, s_k at its 1e-8 floor
    assert torch.all(s_k[2] == torch.tensor(1e-8, dtype=torch.float32))
    assert not k_i8[2].any()


@pytest.mark.parametrize("nan_suffix", [False, True], ids=["zeros", "nan_suffix"])
@pytest.mark.parametrize("d", [64, 128])
def test_one_pass_smoothed_absmax_matches_jax_recipe(d, nan_suffix):
    """The same identity against ``_flash_attention_forward_t_i8``'s
    pre-pass (:835-852) in jax.numpy: k rows past each length multiplied by
    the valid mask (zeros), the mean over all Skv rows, then max|k - mean|.
    The two sums run in other orders: s_k within 1e-6. JAX multiplies the
    mask in, so a NaN suffix would reach its mean; it gets the zero suffix,
    the port the NaN one, and they must agree."""
    lens = [SKV, SKV - 37, 0]
    q, k = _inputs(d, d, lens, False)
    valid = (np.arange(SKV)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    kf = jnp.asarray(k) * jnp.asarray(valid)[:, None, :, None]
    ks = kf - jnp.mean(kf, axis=2, keepdims=True)
    jax_s_q = np.asarray(jnp.maximum(jnp.max(jnp.abs(jnp.asarray(q)), axis=(2, 3)) / 127.0, 1e-8))
    jax_s_k = np.asarray(jnp.maximum(jnp.max(jnp.abs(ks), axis=(2, 3)) / 127.0, 1e-8))
    k_port = _inputs(d, d, lens, nan_suffix)[1]
    s_q, s_k, _ = _one_pass_scales(torch.from_numpy(q), torch.from_numpy(k_port), lens)
    np.testing.assert_array_equal(s_q.numpy(), jax_s_q)
    np.testing.assert_allclose(s_k.numpy(), jax_s_k, rtol=1e-6, atol=0)


def _s32_to_f32(x: np.ndarray) -> np.ndarray:
    """sm90::s32_to_f32: x added to the bits of 1.5 * 2^23 (0x4B400000, ulp
    1), then 1.5 * 2^23 taken off, in float32."""
    bits = (x.astype(np.int64) + 0x4B400000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(12582912.0)


@pytest.mark.parametrize("d", [64, 128])
def test_int32_to_float_without_i2f_is_exact(d):
    """Exact at the extremes of an int8 dot product over D, ±D * 127^2
    (every |q_i8| = |k_i8| = 127), at ±2^22 and on random sums between."""
    top = d * 127 * 127
    assert top < 2 ** 22
    rng = np.random.default_rng(d)
    x = np.concatenate([np.array([top, -top, 0, 1, -1, 2 ** 22, -(2 ** 22), top - 1, 1 - top]),
                        rng.integers(-top, top + 1, 10000)]).astype(np.int32)
    got = _s32_to_f32(x)
    np.testing.assert_array_equal(got, x.astype(np.float32))
    np.testing.assert_array_equal(got.astype(np.int64), x.astype(np.int64))
    # the dot products themselves: rows of ±127 against rows of ±127
    a = rng.choice(np.array([-127, 127], np.int8), (8, d))
    b = np.concatenate([a[:4], -a[4:]])
    dots = (a.astype(np.int32) * b.astype(np.int32)).sum(axis=1)
    assert set(dots.tolist()) == {top, -top}
    np.testing.assert_array_equal(_s32_to_f32(dots), dots.astype(np.float32))


def test_sage_prepass_on_cpu_is_sage_quantize():
    """On CPU tensors the pre-pass wrapper is the plain version, bit for bit;
    on any other device it raises before a launch."""
    q, k = map(torch.from_numpy, _inputs(3, 64, [SKV, 40], True))
    lens = torch.tensor([SKV, 40])
    before = tfa.sage_prepass.launches
    for got, ref in zip(tfa.sage_prepass(q, k, 0.125, lens),
                        tfa.sage_quantize(q, k, 0.125, lens)):
        assert torch.equal(got, ref)
    meta = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tfa.sage_prepass(meta, meta, 0.125)
    assert tfa.sage_prepass.launches == before
