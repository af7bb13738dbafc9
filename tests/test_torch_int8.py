"""W8A8 in the port against the JAX package: the weight quantiser
(``quantize_linear_int8``), the XLA row form (``_int8_linear``), K3's plain
version against the Pallas kernel (``int8_linear_pallas`` in interpret
mode, as ``tests/test_int8_matmul.py`` runs it), the shape rule and the
chunk form's dispatch. Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vap_tpu.models import common as jcommon
from vap_tpu.ops import int8_matmul as jint8
from vap_tpu_torch.models import common as tcommon
from vap_tpu_torch.ops import int8_matmul as tint8

# K3's plain version against the Pallas kernel, in f32: the per-chunk int32
# partials are exact on both sides and the f32 steps are the same in the same
# order, so the outputs differ only where a compiler contracts a multiply-add
# (an ulp of a partial sum); held to 1e-6 of max|ref|
CHUNK_REL_TOL = 1e-6


def _linear(k, n, seed, bias=True):
    """A JAX-layout kernel [K, N] (and bias), 0.02-normal as in the JAX tests."""
    rng = np.random.default_rng(seed)
    p = {"kernel": (rng.standard_normal((k, n)) * 0.02).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(n).astype(np.float32)
    return p


def _quantized(p):
    """(the JAX W8A8 leaf, the port's w_i8 [N, K], s_w, bias) of one linear."""
    jq = jcommon.quantize_linear_int8({k: jnp.asarray(v) for k, v in p.items()})
    w_i8 = torch.from_numpy(np.asarray(jq["w_i8"]).T.copy())
    bias = torch.from_numpy(p["bias"]) if "bias" in p else None
    return jq, w_i8, torch.from_numpy(np.array(jq["s_w"])), bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_linear_int8_matches_jax(dtype):
    """w_i8 identical and s_w equal to the bit, exact .5 ties included: a
    column whose abs-max is 127 has s_w = 1, so w / s_w = w, and 2.5, -3.5,
    0.5 and -0.5 round half to even."""
    kernel = _linear(256, 128, 0)["kernel"]
    kernel[:, 0] = 0.0
    kernel[:5, 0] = [127.0, 2.5, -3.5, 0.5, -0.5]
    jq = jcommon.quantize_linear_int8({"kernel": jnp.asarray(kernel, dtype)})
    w = torch.from_numpy(kernel.T.copy()).to(getattr(torch, dtype))
    w_i8, s_w = tcommon.quantize_linear_int8(w)
    np.testing.assert_array_equal(w_i8.numpy(), np.asarray(jq["w_i8"]).T)
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(jq["s_w"]))
    assert w_i8[0, :5].tolist() == [127, 2, -4, 0, 0]
    assert w_i8.dtype == torch.int8 and s_w.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_form_matches_jax(dtype):
    """``int8_linear_row`` against ``_int8_linear`` under jit, as the model
    runs it, on a 3-D input. Same s_x and x_i8, an exact int32 product and
    the same f32 steps: f32 outputs agree to an ulp of contraction (1e-6 of
    max|ref|); bf16 outputs are the same f32 values rounded, so at most one
    bf16 ulp (2^-7 of max|ref|) apart where such an ulp crosses a rounding
    boundary. Eagerly, JAX divides amax by 127 where jit multiplies by
    f32(1/127): that moves s_x by an ulp and flips roundings of x_i8."""
    p = _linear(384, 256, 1)
    jq, w_i8, s_w, bias = _quantized(p)
    x = (np.random.default_rng(2).standard_normal((2, 37, 384)) * 3).astype(np.float32)
    ref = np.asarray(jax.jit(jcommon._int8_linear)(jq, jnp.asarray(x, dtype))).astype(np.float32)
    got = tcommon.int8_linear_row(torch.from_numpy(x).to(getattr(torch, dtype)), w_i8, s_w, bias)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 37, 256)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())


def _pallas(jq, x):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jint8.int8_linear_pallas(jq, jnp.asarray(x)))


@pytest.mark.parametrize("m,k,n,bias", [
    (64, 256, 128, True),      # one chunk, one N tile
    (130, 3072, 256, False),   # a ragged M and two 1536-column chunks
    (8, 512, 384, True),       # N tiled by 128
    (8, 12288, 128, True),     # the feed-forward's out projection: eight 1536-column chunks
    (130, 1664, 128, False),   # K = 13 x 128: thirteen 128-column chunks
])
def test_chunk_plain_matches_pallas_interpret(m, k, n, bias):
    p = _linear(k, n, 3, bias)
    jq, w_i8, s_w, b = _quantized(p)
    x = (np.random.default_rng(4).standard_normal((m, k)) * 2).astype(np.float32)
    ref = _pallas(jq, x)
    got = tint8.int8_linear_chunk_plain(torch.from_numpy(x), w_i8, s_w, b).numpy()
    assert got.shape == ref.shape == (m, n)
    err = np.abs(got - ref).max()
    assert err <= CHUNK_REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_chunk_limit_catches_a_64_column_chunk(monkeypatch):
    """The limit above sees a chunk of 64 columns in place of _pick's 1536:
    finer scales quantise differently, far above 1e-6 of max|ref|."""
    p = _linear(3072, 256, 3, bias=False)
    jq, w_i8, s_w, _ = _quantized(p)
    x = (np.random.default_rng(4).standard_normal((130, 3072)) * 2).astype(np.float32)
    ref = _pallas(jq, x)
    monkeypatch.setattr(tint8, "BLOCK_K", 64)
    got = tint8.int8_linear_chunk_plain(torch.from_numpy(x), w_i8, s_w).numpy()
    assert np.abs(got - ref).max() > 100 * CHUNK_REL_TOL * np.abs(ref).max()


def test_chunk_and_row_forms_differ_only_by_quantisation():
    """The two activation forms are not the same function: per-(row, chunk)
    scales against per-row ones. Both sit within a few per cent of the
    exact product with the int8 weights (as ``test_int8_matmul.py`` holds
    the JAX pair)."""
    p = _linear(3072, 256, 5)
    _, w_i8, s_w, b = _quantized(p)
    x = torch.from_numpy((np.random.default_rng(6).standard_normal((40, 3072))).astype(np.float32))
    exact = (x.double() @ (w_i8.double() * s_w.double()[:, None]).T + b.double()).float()
    chunk = tint8.int8_linear_chunk_plain(x, w_i8, s_w, b)
    row = tcommon.int8_linear_row(x, w_i8, s_w, b)
    scale = exact.abs().mean()
    assert not torch.equal(chunk, row)
    assert (chunk - exact).abs().mean() / scale < 2e-2
    assert (row - exact).abs().mean() / scale < 2e-2


@pytest.mark.parametrize("n", [100, 128, 384])
@pytest.mark.parametrize("k", [96, 128, 3072, 12288])
def test_supported_matches_jax(k, n):
    want = jint8.supported({"w_i8": jnp.zeros((k, n), jnp.int8)}, jnp.zeros((4, k)))
    assert tint8.supported(torch.zeros((n, k), dtype=torch.int8), torch.zeros((4, k))) == want


def test_supported_rejects_a_3d_weight_as_jax_does():
    w3 = jnp.zeros((2, 256, 128), jnp.int8)
    assert not jint8.supported({"w_i8": w3}, jnp.zeros((4, 256)))
    assert not tint8.supported(torch.zeros((2, 128, 256), dtype=torch.int8), torch.zeros((4, 256)))


def test_chunk_form_dispatch_on_the_cpu():
    """The chunk form takes K3's plain version where ``supported`` (on the
    CPU: no kernel launch) and the row form where not; the row form counts
    its calls. The module switches forms without quantising again."""
    torch.manual_seed(0)
    layer = tcommon.Int8Linear.from_linear(torch.nn.Linear(256, 128), act_scale="chunk")
    x = torch.randn(3, 5, 256)
    launches, calls = tint8.int8_linear_chunk.launches, tcommon.int8_linear_row.calls
    torch.testing.assert_close(layer(x), tint8.int8_linear_chunk_plain(
        x, layer.w_i8, layer.s_w, layer.bias), rtol=0, atol=0)
    assert (tint8.int8_linear_chunk.launches, tcommon.int8_linear_row.calls) == (launches, calls)
    layer.act_scale = "row"
    torch.testing.assert_close(layer(x), tcommon.int8_linear_row(
        x, layer.w_i8, layer.s_w, layer.bias), rtol=0, atol=0)
    assert tcommon.int8_linear_row.calls == calls + 2
    narrow = tcommon.Int8Linear.from_linear(torch.nn.Linear(96, 128), act_scale="chunk")
    narrow(torch.randn(4, 96))  # K = 96 is not tileable: the row form
    assert tcommon.int8_linear_row.calls == calls + 3
    assert tint8.int8_linear_chunk.launches == launches
    with pytest.raises(ValueError, match="act_scale"):
        layer.act_scale = "tensor"


def test_int8_linear_raises_off_cpu_and_cuda():
    layer = tcommon.Int8Linear(256, 128, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        layer(torch.zeros((2, 256), device="meta"))
    with pytest.raises(ValueError, match="not supported"):
        tint8.int8_linear_chunk(torch.zeros((2, 256), device="meta"), layer.w_i8, layer.s_w)
