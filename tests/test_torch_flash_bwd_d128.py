"""The port's attention backward at head_dim 128 (K6) against the JAX package.

``flash_attention_backward_rows_plain`` (what the K6 wrapper runs on CPU
tensors) is held against ``jax.vjp`` of ``vap_tpu.ops.flash_attention.
flash_attention`` at head_dim 128, whose backward is the row-layout
``_flash_attention_backward``, with its Pallas kernels in interpret mode, on
the same numpy inputs and cotangent; ``FlashAttentionFunction`` at head_dim
128 against autograd through plain dense attention. The CUDA kernel itself
is tested on the card by ``test_torch_gpu.py``.
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

# unaligned (Sq, Skv) pairs: ragged last q and kv tiles on both sides
SHAPES = [(300, 200), (128, 257), (64, 77)]
# float32: the same recurrence (P from the lse, delta from out) summed in
# another order and from the two sides' own forwards (JAX's bound form, the
# port's running max), which agree to a few ulps
F32_ATOL = 1e-4
# bfloat16, held as max|err| / max|ref|: both sides round q * scale, ds and p
# to bf16 at the same points, from their own forward's out and lse; a
# rounding flipped by the other summation order moves a term by one bf16 ulp
# (2^-8 relative), and the output is itself rounded to bf16
BF16_REL_TOL = 2e-2


def _inputs(seed, sq, skv, d=128, b=1, h=2):
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


@pytest.mark.parametrize("sq,skv", SHAPES)
def test_k6_plain_matches_jax_vjp_f32(sq, skv):
    x = _inputs(sq * 5 + skv, sq, skv)
    for name, got, ref in zip("qkv", _port_grads(*x, torch.float32),
                              _jax_grads(*x, jnp.float32)):
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("sq,skv", SHAPES)
def test_k6_plain_matches_jax_vjp_bf16(sq, skv):
    x = [a.astype(jnp.bfloat16).astype(np.float32) for a in _inputs(sq + 7 * skv, sq, skv)]
    for name, got, ref in zip("qkv", _port_grads(*x, torch.bfloat16),
                              _jax_grads(*x, jnp.bfloat16)):
        err = np.abs(got - ref).max()
        assert err <= BF16_REL_TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("sq,skv", [(40, 50), (64, 77)])
def test_flash_function_d128_matches_dense_autograd(sq, skv):
    """``FlashAttentionFunction`` at head_dim 128 on CPU tensors (the K4 and
    K6 plain versions) against autograd through ``dense_attention``, f32,
    with a loss that weights every output element differently."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(sq - skv + 200, sq, skv))
    grads = []
    for attn in (tattn.dense_attention, tfa.flash_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (attn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, ref, got in zip("qkv", *grads):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0, msg=f"d{name}")
    # the launch counters count kernel launches only: CPU tensors launch none
    assert tfa.flash_attention_backward.launches_d128 == 0


def test_k6_backward_without_keys_gives_zero_dq():
    q, dout = torch.randn(1, 2, 3, 128), torch.randn(1, 2, 3, 128)
    k = v = torch.zeros(1, 2, 0, 128)
    out, lse = tfa.flash_attention_forward(q, k, v)
    dq, dk, dv = tfa.flash_attention_backward(q, k, v, out, lse, dout)
    assert torch.equal(dq, torch.zeros_like(q)) and dk.shape == dv.shape == k.shape
