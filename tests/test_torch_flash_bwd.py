"""The port's attention backward (K5) against the JAX package.

``flash_attention_backward_plain`` (what the K5 wrapper runs on CPU tensors)
is held against ``jax.vjp`` of ``vap_tpu.ops.flash_attention.flash_attention``
with its Pallas kernels in interpret mode, on the same numpy inputs and
cotangent; ``FlashAttentionFunction`` against autograd through plain dense
attention; and the providers that have no gradient raise. The CUDA kernel
itself is tested on the card by ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vap_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from vap_tpu_torch.ops import attention as tattn
from vap_tpu_torch.ops import flash_attention as tfa

# unaligned (Sq, Skv) pairs: ragged last q and kv tiles on both sides; then
# head_dim 64 at the edges of the card kernels' tiles (128 keys and 64
# queries in the dk/dv pass, 128 queries and 128 keys in the dq pass)
SHAPES = [(300, 200), (128, 257), (64, 77)]
D64_EDGES = [(127, 129), (129, 193), (193, 127)]
# float32: the same recurrence (P from the lse, delta from out) summed in
# another order and from the two sides' own forwards, which agree to 2e-5
F32_ATOL = 1e-4
# bfloat16, held as max|err| / max|ref|: JAX rounds q*scale*log2e to bf16
# before its scores and each side rounds ds and p to bf16 from its own
# forward's out and lse; each rounding moves a term by one bf16 ulp (2^-8
# relative), and the output is itself rounded to bf16
BF16_REL_TOL = 2e-2


def _inputs(seed, sq, skv, d=64, b=1, h=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d), np.float32) for s in (sq, skv, skv, sq)]


def _jax_grads(q, k, v, dout, dtype):
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_flash_attention, *(jnp.asarray(x, dtype) for x in (q, k, v)))
        grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, dout, dtype):
    q, k, v, dout = (torch.from_numpy(x).to(dtype) for x in (q, k, v, dout))
    out, lse = tfa.flash_attention_forward(q, k, v)
    return [g.float().numpy() for g in tfa.flash_attention_backward(q, k, v, out, lse, dout)]


@pytest.mark.parametrize("sq,skv", SHAPES + D64_EDGES)
def test_k5_plain_matches_jax_vjp_f32(sq, skv):
    x = _inputs(sq * 7 + skv, sq, skv)
    for name, got, ref in zip("qkv", _port_grads(*x, torch.float32),
                              _jax_grads(*x, jnp.float32)):
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("sq,skv", SHAPES + D64_EDGES)
def test_k5_plain_matches_jax_vjp_bf16(sq, skv):
    x = [a.astype(jnp.bfloat16).astype(np.float32) for a in _inputs(sq + 3 * skv, sq, skv)]
    for name, got, ref in zip("qkv", _port_grads(*x, torch.bfloat16),
                              _jax_grads(*x, jnp.bfloat16)):
        err = np.abs(got - ref).max()
        assert err <= BF16_REL_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("sq,skv", [(40, 50), (64, 77)])
def test_flash_function_matches_dense_autograd(sq, skv):
    """``FlashAttentionFunction`` on CPU tensors (K1 and K5 plain versions)
    against autograd through ``dense_attention``, f32, with a loss that
    weights every output element differently."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(sq - skv + 100, sq, skv))
    grads = []
    for attn in (tattn.dense_attention, tfa.flash_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (attn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, ref, got in zip("qkv", *grads):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0, msg=f"d{name}")
    # the launch counters count kernel launches only: CPU tensors launch none
    assert tfa.flash_attention_backward.launches == 0
    assert tfa.flash_attention_backward.launches_d64 == 0


def test_full_attention_flash_and_xla_grads_agree():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 33, 21, d=32))
    grads = {}
    for provider in ("flash", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        tattn.full_attention(*leaves, provider=provider).square().sum().backward()
        grads[provider] = [t.grad for t in leaves]
    for ref, got in zip(grads["xla"], grads["flash"]):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("provider", ["sage", "null"])
def test_inference_only_providers_raise_under_grad(provider):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 16, 16))
    with pytest.raises(NotImplementedError, match="gradient"):
        tattn.full_attention(q.requires_grad_(), k, v, provider=provider)
    with torch.no_grad():  # without a gradient they run as before
        assert tattn.full_attention(q, k, v, provider=provider).shape == q.shape


def test_head_dim_128_raises_under_grad_naming_k6():
    """Head_dim 128 takes a gradient through K6 now; above 128 there is no
    backward, and a gradient raises naming K6's head_dim."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(3, 8, 8, d=128))
    tfa.flash_attention(q, k, v.requires_grad_()).sum().backward()
    assert v.grad is not None and v.grad.shape == v.shape
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(3, 8, 8, d=256))
    with pytest.raises(NotImplementedError, match="K6"):
        tfa.flash_attention(q, k, v.requires_grad_())
    assert tfa.flash_attention(q, k, v.detach()).shape == q.shape


def test_backward_without_keys_gives_zero_dq():
    q, dout = torch.randn(1, 2, 3, 64), torch.randn(1, 2, 3, 64)
    k = v = torch.zeros(1, 2, 0, 64)
    out, lse = tfa.flash_attention_forward(q, k, v)
    dq, dk, dv = tfa.flash_attention_backward(q, k, v, out, lse, dout)
    assert torch.equal(dq, torch.zeros_like(q)) and dk.shape == dv.shape == k.shape
