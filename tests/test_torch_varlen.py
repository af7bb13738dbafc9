"""K7, the varlen attention forward, and the dispatcher's providers against
the JAX package.

The plain versions of K7 (what ``flash_attention_forward`` and
``flash_attention_int8_forward`` run on CPU tensors given ``kv_lens``) are
held against ``flash_attention_varlen`` and ``flash_attention_int8(kv_lens=)``
with JAX's Pallas kernels in interpret mode, and against
``dense_attention_masked``, on the same numpy inputs. The CUDA kernels are
held against these plain versions on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.utils.checkpoint import checkpoint

from vap_tpu.ops.attention import dense_attention_masked as jax_masked
from vap_tpu.ops.flash_attention import flash_attention_int8 as jax_int8
from vap_tpu.ops.flash_attention import flash_attention_varlen as jax_varlen
from vap_tpu_torch.ops import attention as tattn
from vap_tpu_torch.ops import flash_attention as tfa

# float32 on both sides: the same softmax over the same keys, summed in
# another order (tiles of 512 keys vs the TPU blocks), as the K1/K4 tests
F32_ATOL = 2e-5
# the int8 recipe is the same; the K mean is summed in another order, which
# can move a value across a rounding boundary by one int8 step (as K2's test)
INT8_ATOL = 1e-4
# lengths: all keys, none, a partial last tile, one key
LENS = [200, 0, 77, 1]


def _qkv(seed, b, sq, skv, d, h=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, h, skv, d), np.float32),
            rng.standard_normal((b, h, skv, d), np.float32))


def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*map(jnp.asarray, args)))


def _garbage_suffix(x, lens, fill):
    """x [B, H, S, D] with every row at or past lens[b] set to ``fill``."""
    pad = np.arange(x.shape[2])[None, :] >= np.asarray(lens)[:, None]
    return np.where(pad[:, None, :, None], np.float32(fill), x)


@pytest.mark.parametrize("d", [64, 128])
def test_k7_plain_matches_jax_varlen(d):
    """D = 64 runs JAX's transposed varlen kernel, D = 128 its row kernel
    (HunyuanVideo's head_dim). Zero rows where a sample has no key, and the
    floored lse -1e4 there."""
    q, k, v = _qkv(d, len(LENS), 130, 200, d)
    lens = np.array(LENS, np.int32)
    ref = _interpret(lambda q, k, v, n: jax_varlen(q, k, v, n), q, k, v, lens)
    dense = np.asarray(jax_masked(*map(jnp.asarray, (q, k, v, lens))))
    out, lse = tfa.flash_attention_forward(*map(torch.from_numpy, (q, k, v)),
                                           kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), dense, atol=F32_ATOL, rtol=0)
    assert np.array_equal(out[1].numpy(), np.zeros_like(q[1]))
    np.testing.assert_allclose(lse[1].numpy(), -1e4, rtol=1e-6)
    # the lse of the valid samples: the natural-log sum over their keys
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5
    for b in (0, 2, 3):
        want = np.log(np.exp(s[b, :, :, :LENS[b]].astype(np.float64)).sum(-1))
        np.testing.assert_allclose(lse[b].numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_k7_int8_plain_matches_jax(d):
    """K7's int8 form: the key rows past each length zeroed before the K
    smoothing, whose mean runs over all Skv rows, as in JAX."""
    q, k, v = _qkv(10 + d, len(LENS), 130, 200, d)
    lens = np.array(LENS, np.int32)
    ref = _interpret(lambda q, k, v, n: jax_int8(q, k, v, kv_lens=n), q, k, v, lens)
    out, lse = tfa.flash_attention_int8_forward(*map(torch.from_numpy, (q, k, v)),
                                                kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=INT8_ATOL, rtol=0)
    assert np.array_equal(out[1].numpy(), np.zeros_like(q[1]))
    assert np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("fill", [np.nan, 1e4])
@pytest.mark.parametrize("fn", [tfa.flash_attention_forward, tfa.flash_attention_int8_forward],
                         ids=["flash", "sage"])
def test_k7_output_ignores_the_suffix(fn, fill):
    """Keys and values at or past each length rewritten to NaN or 1e4: the
    output and lse do not move, to the bit."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, len(LENS), 70, 200, 64))
    lens = torch.tensor(LENS)
    base = fn(q, k, v, kv_lens=lens)
    k2, v2 = (torch.from_numpy(_garbage_suffix(x.numpy(), LENS, fill)) for x in (k, v))
    got = fn(q, k2, v2, kv_lens=lens)
    for g, b in zip(got, base):
        assert torch.equal(g, b)


def test_k7_lengths_are_clamped_as_in_jax():
    """A length above Skv means all keys, one below 0 none (``_varlen_valid``).
    One sample against the batch: the same sums, another BLAS call (1e-6)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 2, 20, 30, 64))
    out, _ = tfa.flash_attention_forward(q, k, v, kv_lens=torch.tensor([99, -3]))
    full, _ = tfa.flash_attention_forward(q, k, v)
    torch.testing.assert_close(out[0], full[0], atol=1e-6, rtol=0)
    assert not out[1].any()


def test_k7_rejects_bad_kv_lens():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 8, 8, 64))
    for lens in (torch.tensor([8]), torch.tensor([8.0, 8.0]), [8, 8]):
        with pytest.raises(ValueError, match="kv_lens"):
            tfa.flash_attention_forward(q, k, v, kv_lens=lens)


# ---------------------------------------------------------------------------
# K7's backward: K5 and K6 given kv_lens
# ---------------------------------------------------------------------------

# float32 on both sides, held against 1e-4 of the gradient's scale: the same
# recurrence (P from the lse, delta from out) summed in another order and
# from each side's own forward, as the K5 and K6 backward tests
BWD_ATOL = 1e-4


def _close_scaled(got, want, atol, name):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0, err_msg=name)


def _k7_grads(q, k, v, dout, lens):
    """The port's K7 forward, then its backward, on CPU tensors (the plain
    versions: K5's form below head_dim 128, K6's at 128)."""
    q, k, v, dout = map(torch.from_numpy, (q, k, v, dout))
    n = torch.from_numpy(np.asarray(lens, np.int32))
    out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=n)
    return [g.numpy() for g in tfa.flash_attention_backward(q, k, v, out, lse, dout, kv_lens=n)]


def _jax_vjp(fn, q, k, v, dout, lens, interpret):
    args = [jnp.asarray(x) for x in (q, k, v)]
    n = jnp.asarray(np.asarray(lens, np.int32))
    with pltpu.force_tpu_interpret_mode() if interpret else contextlib.nullcontext():
        _, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, n), *args)
        return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("d", [64, 128])
def test_k7_backward_plain_matches_jax_vjp(d):
    """D = 64 runs JAX's transposed backward with its per-(b,h) bias column,
    D = 128 its row kernels with the per-sample bias: ``jax.vjp`` of
    ``flash_attention_varlen`` in interpret mode, and of
    ``dense_attention_masked``. The dk and dv rows past each length are
    exact zeros, and the sample with no key gets dq = 0."""
    q, k, v = _qkv(20 + d, len(LENS), 130, 200, d)
    dout = np.random.default_rng(30 + d).standard_normal(q.shape).astype(np.float32)
    got = _k7_grads(q, k, v, dout, LENS)
    ref = _jax_vjp(jax_varlen, q, k, v, dout, LENS, interpret=True)
    dense = _jax_vjp(jax_masked, q, k, v, dout, LENS, interpret=False)
    for name, g, r, dn in zip("qkv", got, ref, dense):
        _close_scaled(g, r, BWD_ATOL, f"d{name} vs flash_attention_varlen")
        _close_scaled(g, dn, BWD_ATOL, f"d{name} vs dense_attention_masked")
    for b, n in enumerate(LENS):
        assert not got[1][b, :, n:].any() and not got[2][b, :, n:].any(), b
    assert not got[0][1].any()
    assert all(np.isfinite(g).all() for g in got)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("fill", [np.nan, 1e4])
def test_k7_backward_ignores_the_suffix(fill, d):
    """Keys and values past each length rewritten to NaN or 1e4: dq, dk and
    dv do not move, to the bit, and the rows past each length stay 0."""
    q, k, v = _qkv(40 + d, len(LENS), 70, 200, d)
    dout = np.random.default_rng(50 + d).standard_normal(q.shape).astype(np.float32)
    base = _k7_grads(q, k, v, dout, LENS)
    got = _k7_grads(q, _garbage_suffix(k, LENS, fill), _garbage_suffix(v, LENS, fill), dout, LENS)
    for g, b in zip(got, base):
        assert np.array_equal(g, b)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_function_k7_matches_dense_autograd(d):
    """``flash_attention(kv_lens=)`` under grad (``FlashAttentionFunction``:
    K7's forward and backward, plain on CPU tensors) against autograd
    through ``dense_attention_masked``, f32, with a loss that weights every
    output element differently; then the same through a non-reentrant
    ``torch.utils.checkpoint``, whose recompute must carry ``kv_lens``."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(60 + d, len(LENS), 50, 200, d))
    w = torch.from_numpy(np.random.default_rng(70 + d).standard_normal(q.shape).astype(np.float32))
    lens = torch.tensor(LENS)

    def grads(attn, remat):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn = lambda *x: attn(*x, kv_lens=lens)  # noqa: E731
        out = checkpoint(fn, *leaves, use_reentrant=False) if remat else fn(*leaves)
        (out * w).sum().backward()
        return [t.grad for t in leaves]

    want = grads(tattn.dense_attention_masked, False)
    for remat in (False, True):
        for name, g, r in zip("qkv", grads(tfa.flash_attention, remat), want):
            _close_scaled(g.numpy(), r.numpy(), BWD_ATOL, f"d{name}, remat {remat}")


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

def test_masked_dense_matches_jax_and_is_differentiable():
    """The xla provider's masked form: f32 scores and P V, -1e30 bias,
    exact zero rows for kv_lens == 0, finite gradients."""
    q, k, v = _qkv(7, len(LENS), 40, 200, 32)
    lens = np.array(LENS, np.int32)
    want = np.asarray(jax_masked(*map(jnp.asarray, (q, k, v, lens))))
    tq = torch.from_numpy(q).requires_grad_()
    with tattn.attention_provider("xla"):
        got = tattn.full_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                                   kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    assert not got[1].any()
    got.square().sum().backward()
    assert torch.isfinite(tq.grad).all()


@pytest.mark.parametrize("provider", ["flash", "flash_varlen", "jax_flash"])
def test_flash_providers_take_k7(provider):
    """flash, flash_varlen and jax_flash (JAX's library kernel there, not a
    kernel of the repo) run K1/K4, and K7 with kv_lens."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 2, 40, 60, 64))
    lens = torch.tensor([60, 21])
    with tattn.attention_provider(provider):
        got = tattn.full_attention(q, k, v, kv_lens=lens)
        fixed = tattn.full_attention(q, k, v)
    assert torch.equal(got, tfa.flash_attention_forward(q, k, v, kv_lens=lens)[0])
    assert torch.equal(fixed, tfa.flash_attention_forward(q, k, v)[0])


@pytest.mark.parametrize("provider", ["flash", "flash_varlen", "jax_flash"])
def test_flash_providers_differentiate_k7(provider):
    """Under grad the three providers run ``flash_attention`` with
    ``kv_lens`` (K7's forward and backward): the same gradients, to the
    bit, and zero dk rows past each length."""
    q, k, v = _qkv(11, 2, 40, 60, 64)
    lens = torch.tensor([60, 21])
    grads = []
    for fn in (lambda *x: tattn.full_attention(*x, provider=provider, kv_lens=lens),
               lambda *x: tfa.flash_attention(*x, kv_lens=lens)):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        fn(*leaves).square().sum().backward()
        grads.append([t.grad for t in leaves])
    for g, r in zip(*grads):
        assert torch.equal(g, r)
    assert not grads[0][1][1, :, 21:].any()


def test_sage_provider_takes_k7():
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 2, 40, 64, 64))
    lens = torch.tensor([64, 30])
    with tattn.attention_provider("sage"):
        got = tattn.full_attention(q, k, v, kv_lens=lens)
    assert torch.equal(got, tfa.flash_attention_int8_forward(q, k, v, kv_lens=lens)[0])


def test_dispatcher_raises_as_jax_does():
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, 2, 8, 8, 64))
    lens = torch.tensor([8, 3])
    seg = (torch.zeros(2, 8, dtype=torch.int64), torch.zeros(2, 8, dtype=torch.int64), 1)
    assert set(tattn._VALID_PROVIDERS) == {"flash", "flash_varlen", "sage", "jax_flash", "xla",
                                           "ring", "null"}
    for provider in ("flash", "sage", "xla", "ring"):
        with pytest.raises(ValueError, match="mutually exclusive"):
            tattn.full_attention(q, k, v, provider=provider, kv_lens=lens, segment_ids=seg)
    with pytest.raises(ValueError, match="unknown attention provider"):
        tattn.attention_provider("bogus").__enter__()
    from vap_tpu_torch.parallel import sequence_parallel_attention
    with pytest.raises(ValueError, match="unknown rotate_method"):
        sequence_parallel_attention(q, k, v, mesh=None, rotate_method="alltoall")
