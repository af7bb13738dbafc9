"""The port's attention kernels (K1 flash, K2 sage) and provider registry
against the JAX package.

The CPU tests hold each kernel's plain PyTorch version (what its wrapper runs
on CPU tensors) against the JAX Pallas kernel in interpret mode, on the same
numpy inputs. The CUDA kernels themselves are tested on the card by
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vap_tpu.ops.flash_attention import (
    DEFAULT_BLOCK_Q_T,
    LANES,
    _cdiv,
    _flash_attention_forward_t,
    _flash_attention_forward_t_i8,
)
from vap_tpu_torch.ops import attention as tattn
from vap_tpu_torch.ops import flash_attention as tfa

# unaligned (Sq, Skv) pairs: ROADMAP Queue 3 "short, unaligned KV"
SHAPES = [(300, 200), (128, 257), (64, 77)]
# float32 inputs: both sides compute the same softmax in f32 and differ only
# in summation order (tiles of 512 keys vs the TPU blocks)
F32_ATOL = 2e-5
# bfloat16 inputs: JAX rounds q*scale*log2e to bf16 before QK^T, the port
# scales the f32 scores; P is rounded to bf16 on both sides at other points
BF16_OUT_ATOL = 1e-2
BF16_LSE_ATOL = 1e-2


def _qkv(seed, sq, skv, d=64, b=1, h=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, h, skv, d), np.float32),
            rng.standard_normal((b, h, skv, d), np.float32))


def _blocks(sq, skv):
    """The block sizes ``_forward_dispatch`` picks at head_dim < 128."""
    bq = max(min(DEFAULT_BLOCK_Q_T, _cdiv(sq, LANES) * LANES), LANES)
    bk = max(min(512, _cdiv(skv, 8) * 8), 8)
    return bq, bk


def _jax_k1(q, k, v, use_bound, dtype=jnp.float32):
    bq, bk = _blocks(q.shape[2], k.shape[2])
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_attention_forward_t(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            q.shape[-1] ** -0.5, bq, bk, use_bound=use_bound)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _jax_k2(q, k, v, use_bound=True, dtype=jnp.float32):
    bq, bk = _blocks(q.shape[2], k.shape[2])
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_attention_forward_t_i8(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            q.shape[-1] ** -0.5, bq, bk, use_bound=use_bound)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


@pytest.mark.parametrize("use_bound", [True, False], ids=["bound", "runmax"])
@pytest.mark.parametrize("sq,skv", SHAPES)
def test_k1_plain_matches_jax_f32(sq, skv, use_bound):
    q, k, v = _qkv(sq + skv, sq, skv)
    ref_out, ref_lse = _jax_k1(q, k, v, use_bound)
    out, lse = tfa.flash_attention_forward(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref_out, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=F32_ATOL, rtol=0)


def test_k1_plain_matches_jax_bf16():
    q, k, v = _qkv(3, 300, 200)
    ref_out, ref_lse = _jax_k1(q, k, v, True, jnp.bfloat16)
    out, lse = tfa.flash_attention_forward(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=BF16_OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=BF16_LSE_ATOL, rtol=0)


@pytest.mark.parametrize("sq,skv", SHAPES)
def test_k2_plain_matches_jax(sq, skv):
    q, k, v = _qkv(10 + sq, sq, skv)
    ref_out, ref_lse = _jax_k2(q, k, v)
    out, lse = tfa.flash_attention_int8_forward(*map(torch.from_numpy, (q, k, v)))
    # same int8 recipe; the K mean is summed in another order, which could
    # move a value across a rounding boundary by one int8 step
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_bound", [True, False], ids=["bound", "runmax"])
@pytest.mark.parametrize("sq,skv", SHAPES)
def test_k2_plain_matches_jax_bf16(sq, skv, use_bound):
    """bf16 inputs, as on the main path: P rounded to bf16 and a bf16 P V on
    both sides. The int8 scores agree exactly; P is rounded against the
    running max here and against the per-query bound (or the TPU's block
    maxima) there, which moves a bf16 output by a few ulps."""
    q, k, v = (x.astype(jnp.bfloat16).astype(np.float32) for x in _qkv(20 + sq, sq, skv))
    ref_out, ref_lse = _jax_k2(q, k, v, use_bound, jnp.bfloat16)
    out, lse = tfa.flash_attention_int8_forward(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=BF16_OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=BF16_LSE_ATOL, rtol=0)


def test_k2_quantization_matches_jax_recipe():
    q, k, _ = _qkv(5, 64, 77)
    q_i8, k_i8, sqk = tfa.sage_quantize(torch.from_numpy(q), torch.from_numpy(k), 0.125)
    kf = k - k.mean(axis=2, keepdims=True)
    s_q = np.maximum(np.abs(q).max(axis=(2, 3), keepdims=True) / 127.0, 1e-8)
    s_k = np.maximum(np.abs(kf).max(axis=(2, 3), keepdims=True) / 127.0, 1e-8)
    np.testing.assert_array_equal(q_i8.numpy(), np.round(q / s_q).astype(np.int8))
    assert np.abs(k_i8.numpy().astype(int) - np.round(kf / s_k).astype(int)).max() <= 1
    np.testing.assert_allclose(sqk.numpy(), (s_q * s_k * 0.125 * tfa.LOG2_E).reshape(1, 2),
                               rtol=1e-6)
    # half-to-even rounding, as jnp.round
    assert torch.round(torch.tensor([0.5, 1.5, -2.5])).tolist() == [0.0, 2.0, -2.0]


def test_all_keys_padded_tile_is_finite():
    """ROADMAP Queue 3 "fully masked KV tiles": a tile whose keys are all
    padded (scores at NEG_INF, v rows zero, as the kernels fill them) gives
    no NaN and leaves the result of the valid keys unchanged; with no valid
    key at all the l == 0 guard returns zeros and a finite lse."""
    rng = np.random.default_rng(0)
    s_valid = torch.from_numpy(rng.standard_normal((2, 5, 7), np.float32))
    v_valid = torch.from_numpy(rng.standard_normal((2, 7, 4), np.float32))
    m0 = torch.full((2, 5, 1), tfa.NEG_INF)
    l0, acc0 = torch.zeros((2, 5, 1)), torch.zeros((2, 5, 4))

    padded = (torch.full((2, 5, 8), tfa.NEG_INF), torch.zeros((2, 8, 4)))
    m, l, acc = tfa.softmax_tile_update(m0, l0, acc0, *padded)
    assert torch.isfinite(m).all() and torch.isfinite(l).all() and torch.isfinite(acc).all()
    out, lse = tfa.softmax_finalize(*tfa.softmax_tile_update(m, l, acc, s_valid, v_valid),
                                    torch.float32)
    ref_out, ref_lse = tfa.softmax_finalize(
        *tfa.softmax_tile_update(m0, l0, acc0, s_valid, v_valid), torch.float32)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)

    q = torch.randn(1, 2, 3, 64)
    out, lse = tfa.flash_attention_forward(q, torch.zeros(1, 2, 0, 64), torch.zeros(1, 2, 0, 64))
    assert torch.equal(out, torch.zeros_like(q)) and torch.isfinite(lse).all()


def test_provider_registry():
    assert tattn._parse_provider_spec("sage") == {"default": "sage"}
    assert tattn._parse_provider_spec("sage joint:flash") == {"default": "sage",
                                                              "joint": "flash"}
    with pytest.raises(ValueError, match="unknown attention provider"):
        tattn._parse_provider_spec("cudnn")
    with pytest.raises(ValueError, match="empty"):
        tattn._parse_provider_spec(" ")
    with pytest.raises(ValueError, match="unknown attention provider"):
        with tattn.attention_provider("flash joint:bogus"):
            pass
    assert tattn.get_attention_provider("joint") == "flash"
    with tattn.attention_provider("xla joint:sage"):
        assert tattn.get_attention_provider("joint") == "sage"
        assert tattn.get_attention_provider("cross") == "xla"
    assert tattn.get_attention_provider() == tattn.DEFAULT_PROVIDER == "flash"


@pytest.mark.parametrize("provider", ["flash", "sage", "xla"])
def test_providers_agree_on_cpu(provider):
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 40, 50))
    ref = tattn.dense_attention(q, k, v)
    out = tattn.full_attention(q, k, v, provider=provider)
    torch.testing.assert_close(out, ref, atol=2e-2 if provider == "sage" else 1e-5, rtol=0)


def test_non_cpu_tensor_does_not_fall_back():
    """The wrappers run the plain version only for CPU tensors: any other
    device (here 'meta', which every build has) raises before a launch."""
    q = torch.empty((1, 2, 8, 64), device="meta")
    launches = (tfa.flash_attention_forward.launches, tfa.flash_attention_int8_forward.launches)
    for fn in (tfa.flash_attention_forward, tfa.flash_attention_int8_forward):
        with pytest.raises(ValueError, match="not supported"):
            fn(q, q, q)
    assert (tfa.flash_attention_forward.launches,
            tfa.flash_attention_int8_forward.launches) == launches
