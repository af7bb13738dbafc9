"""The port's CUDA kernels (K1 and K4 flash, K2 sage, K5 and K6 flash
backward, K3 W8A8, K9 and K10 the GEMM rate probe) against their plain
PyTorch versions on the card.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from vap_tpu_torch.ops import flash_attention as tfa

KERNELS = {
    "flash": (tfa.flash_attention_forward, tfa.flash_attention_forward_plain),
    "sage": (tfa.flash_attention_int8_forward, tfa.flash_attention_int8_forward_plain),
}
# the launch counter of each kernel: K1 below head_dim 128, K4 at 128
COUNTERS = {("flash", False): "launches", ("flash", True): "launches_d128",
            ("sage", False): "launches", ("sage", True): "launches"}
# bf16 output, held as max|out - ref| / max|ref|: kernel and plain version
# round P to bf16 against different running maxima, which moves an output by
# about one bf16 ulp, at most 2^-7 of max|ref|
OUT_REL_TOL = 2e-2
LSE_ATOL = 1e-2
KV_TILE = 64  # keys per tile of both kernels

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(device, sq, skv, d=64, b=1, h=2, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32))
                 .to(device, torch.bfloat16) for s in (sq, skv, skv))


def _check(name, q, k, v):
    kernel, plain = KERNELS[name]
    counter = COUNTERS[name, q.shape[-1] == 128]
    before = getattr(kernel, counter)
    out, lse = kernel(q, k, v)
    torch.cuda.synchronize()
    assert getattr(kernel, counter) == before + 1
    ref_out, ref_lse = plain(q, k, v)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0,
                               atol=OUT_REL_TOL * ref_out.float().abs().max().item())
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["flash", "sage"])
@pytest.mark.parametrize("sq,skv", [(300, 200), (128, 257), (64, 77), (1, 1), (65, 64)])
def test_kernel_matches_plain(cuda, name, sq, skv):
    _check(name, *_qkv(cuda, sq, skv))


@pytest.mark.parametrize("name", ["flash", "sage"])
@pytest.mark.parametrize("skv", [512, 257])
def test_kernel_matches_plain_wan_cross_keys(cuda, name, skv):
    """Wan's cross-attention key counts (512 text tokens, 257 CLIP tokens)
    at head_dim 128; the full Sq of 20,280 runs in chip_smoke.py."""
    _check(name, *_qkv(cuda, 300, skv, d=128))


@pytest.mark.parametrize("name,d", [("flash", d) for d in (16, 32, 48, 80, 96, 112, 128)]
                         + [("sage", 32), ("sage", 96), ("sage", 128)])
def test_kernel_head_dims(cuda, name, d):
    _check(name, *_qkv(cuda, 130, 70, d=d))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", ["flash", "sage"])
def test_limit_catches_v_rows_out_of_place(cuda, name, d):
    """A planted fault: V rows rolled by one inside every kv tile, as a
    kernel that mixed up the rows of a tile would read them. Held against
    the plain version on the true V, it must break the out limit."""
    kernel, plain = KERNELS[name]
    q, k, v = _qkv(cuda, 300, 200, d=d)
    n = v.shape[2] // KV_TILE * KV_TILE
    tiles = v[:, :, :n].unflatten(2, (-1, KV_TILE)).roll(1, dims=3).flatten(2, 3)
    out = kernel(q, k, torch.cat([tiles, v[:, :, n:]], dim=2))[0].float()
    ref = plain(q, k, v)[0].float()
    assert (out - ref).abs().max() > OUT_REL_TOL * ref.abs().max()


def test_flash_without_keys_is_finite(cuda):
    """No key at all: the l == 0 guard gives zeros and a finite lse."""
    q, k, v = _qkv(cuda, 3, 0)
    out, lse = tfa.flash_attention_forward(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(q)) and torch.isfinite(lse).all()


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention_forward(q, q, q)
    qb = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_forward(qb, qb, qb)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_int8_forward(*_qkv(cuda, 8, 8, d=160))


def test_flash_raises_at_head_dim_256(cuda):
    """Head_dim above 128 has no kernel yet: the wrapper raises, launches
    nothing and does not fall back."""
    counts = (tfa.flash_attention_forward.launches, tfa.flash_attention_forward.launches_d128)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_forward(*_qkv(cuda, 8, 8, d=256))
    assert (tfa.flash_attention_forward.launches,
            tfa.flash_attention_forward.launches_d128) == counts


# K5: dq, dk and dv each held as max|err| / max|ref|. Kernel and plain version
# round ds and p to bf16 at the same points from the same out and lse; exp2
# and the summation order differ, which flips a rounding by one bf16 ulp
# (2^-8 relative) now and then, and each output is itself rounded to bf16
GRAD_REL_TOL = 2e-2
Q_TILE = 64  # queries per tile of the dk/dv kernel


def _bwd_inputs(device, sq, skv, d=64, seed=2):
    q, k, v = _qkv(device, sq, skv, d=d, seed=seed)
    out, lse = tfa.flash_attention_forward(q, k, v)
    dout = torch.randn(q.shape, generator=torch.Generator(device).manual_seed(seed),
                       device=device).to(torch.bfloat16)
    return q, k, v, out, lse, dout


def _grad_errors(got, ref):
    return [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
            for g, r in zip(got, ref)]


# not (1, 1): with one key p = 1 and ds = p (dp - delta) is 0 up to rounding,
# so dq and dk are rounding noise and a relative measure means nothing
@pytest.mark.parametrize("sq,skv", [(300, 200), (128, 257), (64, 77), (1, 9), (65, 64)])
@pytest.mark.parametrize("d", [64, 32])
def test_k5_matches_plain(cuda, sq, skv, d):
    args = _bwd_inputs(cuda, sq, skv, d=d)
    before = tfa.flash_attention_backward.launches
    got = tfa.flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert tfa.flash_attention_backward.launches == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, tfa.flash_attention_backward_plain(*args))
    assert max(errs) <= GRAD_REL_TOL, errs


def test_k5_limit_catches_dout_rows_out_of_place(cuda):
    """A planted fault: dout rows rolled by one inside every 64-query tile,
    as a kernel that mixed up the rows of a dout tile would read them. Held
    against the plain version on the true dout, dq, dk and dv must each
    break the limit."""
    q, k, v, out, lse, dout = _bwd_inputs(cuda, 300, 200)
    n = dout.shape[2] // Q_TILE * Q_TILE
    tiles = dout[:, :, :n].unflatten(2, (-1, Q_TILE)).roll(1, dims=3).flatten(2, 3)
    faulty = torch.cat([tiles, dout[:, :, n:]], dim=2).contiguous()
    errs = _grad_errors(tfa.flash_attention_backward(q, k, v, out, lse, faulty),
                        tfa.flash_attention_backward_plain(q, k, v, out, lse, dout))
    assert min(errs) > GRAD_REL_TOL, errs


def test_k5_is_deterministic(cuda):
    args = _bwd_inputs(cuda, 300, 200)
    first = tfa.flash_attention_backward(*args)
    second = tfa.flash_attention_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_function_grads_on_the_card(cuda):
    """``FlashAttentionFunction`` (K1 then K5) against autograd through
    plain dense attention in float32 on the same bf16 inputs."""
    from vap_tpu_torch.ops.attention import dense_attention

    q, k, v = _qkv(cuda, 300, 200)
    w = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(5), device=cuda)
    grads = []
    for attn, dtype in ((tfa.flash_attention, torch.bfloat16), (dense_attention, torch.float32)):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        (attn(*leaves).float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    errs = _grad_errors(*grads)
    assert max(errs) <= GRAD_REL_TOL, errs


def test_k5_rejects_head_dim_128(cuda):
    """K5 takes head_dim below 128: at 128 the wrapper launches K6 in its
    place, and above 128 it raises and launches nothing."""
    counts = (tfa.flash_attention_backward.launches, tfa.flash_attention_backward.launches_d128)
    tfa.flash_attention_backward(*_bwd_inputs(cuda, 8, 8, d=128))
    assert (tfa.flash_attention_backward.launches,
            tfa.flash_attention_backward.launches_d128) == (counts[0], counts[1] + 1)
    q, k, v = _qkv(cuda, 8, 8, d=256)
    lse = torch.zeros(q.shape[:3], device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_backward(q, k, v, q, lse, q)
    assert tfa.flash_attention_backward.launches_d128 == counts[1] + 1


# K6, the backward at head_dim 128: the same limit. Kernel and plain version
# round q * scale, ds and p to bf16 at the same points from the same out and
# lse; exp and the summation order differ, which flips a rounding by one bf16
# ulp now and then, and each output is itself rounded to bf16
@pytest.mark.parametrize("sq,skv", [(300, 200), (128, 257), (64, 77), (1, 9), (65, 64),
                                    (130, 512)])
def test_k6_matches_plain(cuda, sq, skv):
    args = _bwd_inputs(cuda, sq, skv, d=128)
    before = tfa.flash_attention_backward.launches_d128
    got = tfa.flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert tfa.flash_attention_backward.launches_d128 == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, tfa.flash_attention_backward_rows_plain(*args))
    assert max(errs) <= GRAD_REL_TOL, errs


def test_k6_limit_catches_dout_rows_out_of_place(cuda):
    """The planted fault of K5's test, at head_dim 128: dout rows rolled by
    one inside every 64-query tile must break the limit in dq, dk and dv."""
    q, k, v, out, lse, dout = _bwd_inputs(cuda, 300, 200, d=128)
    n = dout.shape[2] // Q_TILE * Q_TILE
    tiles = dout[:, :, :n].unflatten(2, (-1, Q_TILE)).roll(1, dims=3).flatten(2, 3)
    faulty = torch.cat([tiles, dout[:, :, n:]], dim=2).contiguous()
    errs = _grad_errors(tfa.flash_attention_backward(q, k, v, out, lse, faulty),
                        tfa.flash_attention_backward_rows_plain(q, k, v, out, lse, dout))
    assert min(errs) > GRAD_REL_TOL, errs


def test_k6_is_deterministic(cuda):
    args = _bwd_inputs(cuda, 300, 257, d=128)
    first = tfa.flash_attention_backward(*args)
    second = tfa.flash_attention_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_function_grads_on_the_card_d128(cuda):
    """``FlashAttentionFunction`` at head_dim 128 (K4 then K6) against
    autograd through plain dense attention in float32 on the same bf16
    inputs, with Wan's unaligned CLIP key count."""
    from vap_tpu_torch.ops.attention import dense_attention

    q, k, v = _qkv(cuda, 300, 257, d=128)
    w = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(5), device=cuda)
    counts = (tfa.flash_attention_forward.launches_d128, tfa.flash_attention_backward.launches_d128)
    grads = []
    for attn, dtype in ((tfa.flash_attention, torch.bfloat16), (dense_attention, torch.float32)):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        (attn(*leaves).float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    assert (tfa.flash_attention_forward.launches_d128,
            tfa.flash_attention_backward.launches_d128) == (counts[0] + 1, counts[1] + 1)
    errs = _grad_errors(*grads)
    assert max(errs) <= GRAD_REL_TOL, errs


# K3, the W8A8 linear: per chunk the int32 product is exact on both sides and
# the f32 steps are the same in the same order, so an output of the kernel
# can at most round to the bf16 value next to its plain version's, one ulp:
# at most 2^-7 of the element, of max|ref|; held to that
W8A8_REL_TOL = 2.0 ** -7
W8A8_TILE = 128  # output channels per tile of the GEMM


def _w8a8_inputs(device, m, k, n, bias=True, seed=3):
    from vap_tpu_torch.models.common import quantize_linear_int8

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32) * 2).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((n, k), np.float32) * 0.02).to(device)
    w_i8, s_w = quantize_linear_int8(w)
    b = torch.from_numpy(rng.standard_normal(n, np.float32)).to(device) if bias else None
    return x, w_i8, s_w, b


@pytest.mark.parametrize("m,k,n,bias", [(300, 256, 128, True), (300, 3072, 384, False),
                                        (1, 256, 128, True), (129, 12288, 256, True)])
def test_k3_matches_plain(cuda, m, k, n, bias):
    from vap_tpu_torch.ops import int8_matmul as ti8

    x, w_i8, s_w, b = _w8a8_inputs(cuda, m, k, n, bias)
    before = ti8.int8_linear_chunk.launches
    out = ti8.int8_linear_chunk(x, w_i8, s_w, b)
    torch.cuda.synchronize()
    assert ti8.int8_linear_chunk.launches == before + 1
    ref = ti8.int8_linear_chunk_plain(x, w_i8, s_w, b)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n) and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=W8A8_REL_TOL * ref.float().abs().max().item())


def test_k3_limit_catches_weight_rows_out_of_place(cuda):
    """A planted fault: the weight's rows rolled by one inside every 128-row
    tile, as a kernel that mixed up the output channels of a tile would
    read them. Held against the plain version, it must break the limit."""
    from vap_tpu_torch.ops import int8_matmul as ti8

    x, w_i8, s_w, b = _w8a8_inputs(cuda, 300, 3072, 384)
    rolled = w_i8.unflatten(0, (-1, W8A8_TILE)).roll(1, dims=1).flatten(0, 1).contiguous()
    ref = ti8.int8_linear_chunk_plain(x, w_i8, s_w, b).float()
    out = ti8.int8_linear_chunk(x, rolled, s_w, b).float()
    assert (out - ref).abs().max() > W8A8_REL_TOL * ref.abs().max()


def test_k3_rejects_what_it_does_not_take(cuda):
    from vap_tpu_torch.ops import int8_matmul as ti8

    x, w_i8, s_w, b = _w8a8_inputs(cuda, 8, 256, 128)
    before = ti8.int8_linear_chunk.launches
    with pytest.raises(ValueError, match="bfloat16"):
        ti8.int8_linear_chunk(x.float(), w_i8, s_w, b)
    with pytest.raises(ValueError, match="tileable"):
        ti8.int8_linear_chunk(x[:, :96].contiguous(), w_i8[:, :96].contiguous(), s_w, b)
    assert ti8.int8_linear_chunk.launches == before


def test_int8_linear_chunk_form_launches_k3(cuda):
    """The chunk form of ``Int8Linear`` launches K3 where ``supported`` and
    takes the row form where not, counting each."""
    from vap_tpu_torch.models import common as tc
    from vap_tpu_torch.ops import int8_matmul as ti8

    wide = tc.Int8Linear.from_linear(torch.nn.Linear(256, 128, device=cuda, dtype=torch.bfloat16))
    narrow = tc.Int8Linear.from_linear(torch.nn.Linear(96, 128, device=cuda, dtype=torch.bfloat16))
    launches, calls = ti8.int8_linear_chunk.launches, tc.int8_linear_row.calls
    wide(torch.randn(2, 5, 256, device=cuda, dtype=torch.bfloat16))
    narrow(torch.randn(2, 5, 96, device=cuda, dtype=torch.bfloat16))
    assert (ti8.int8_linear_chunk.launches, tc.int8_linear_row.calls) == (launches + 1, calls + 1)


# K9 and K10, the GEMM rate probe: int8 gives the exact int32 product, held
# bit for bit; bf16 sums in f32 in another order than the plain version and
# rounds to bf16, so an output may land on the neighbouring bf16 value, one
# ulp, at most 2^-7 of it
GEMM_BF16_REL_TOL = 2.0 ** -7


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(300, 256, 128), (144, 3072, 384), (16, 64, 256)])
def test_gemm_probe_matches_plain(cuda, trans, dtype, m, k, n):
    from vap_tpu_torch.ops import gemm_probe as gp

    rng = np.random.default_rng(4)
    if dtype == torch.int8:
        x, w = (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8)).to(cuda)
                for s in ((m, k), (n, k)))
    else:
        x, w = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda, dtype)
                for s in ((m, k), (n, k)))
    if trans and m % 16:
        m, x = m - m % 16, x[: m - m % 16].contiguous()
    kernel = gp.gemm_probe_t if trans else gp.gemm_probe
    before = kernel.launches
    out = kernel(x.T.contiguous(), w) if trans else kernel(x, w)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = gp.gemm_probe_plain(x, w)
    assert out.dtype == ref.dtype and out.shape == (m, n)
    if dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=GEMM_BF16_REL_TOL * ref.float().abs().max().item())


def test_gemm_probe_rejects_what_it_does_not_take(cuda):
    from vap_tpu_torch.ops import gemm_probe as gp

    x = torch.zeros((32, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="N %"):
        gp.gemm_probe(x, torch.zeros((100, 64), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="M % 16"):
        gp.gemm_probe_t(torch.zeros((64, 30), dtype=torch.int8, device=cuda),
                        torch.zeros((128, 64), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="int8 or bfloat16"):
        gp.gemm_probe(x.float(), torch.zeros((128, 64), device=cuda))
