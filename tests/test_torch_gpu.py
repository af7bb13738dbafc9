"""The port's CUDA kernels (K1 and K4 flash, K2 sage and its pre-pass, K7 their varlen form,
K8 their packed-segment form and the ring body over it, K5 and K6 flash
backward and K7's and K8's backward in them, the ring backward over them,
K3 W8A8, K9 and K10 the GEMM rate probe) against their plain PyTorch
versions on the card; the wgmma and TMA kernels (K1, K2 and K5 at head_dim
64, K4, K2 and K6 at 128, and K7 in them; K3, K9 and K10) also at their
tile edges.

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


def _counter(name, d, varlen=False):
    """The launch counter a call takes: the entry ``kernel_entry`` names by
    head_dim for flash (K1 at 64, K1's mma.sync form below 128 else, K4 at
    128), ``sage_entry`` for sage (K2's wgmma kernels at 64 and 128, its
    mma.sync kernel at 32 and 96)."""
    if name == "flash":
        return tfa.kernel_entry(False, d, varlen=varlen)[2]
    return tfa.sage_entry(d, varlen=varlen)[2]


# bf16 output, held as max|out - ref| / max|ref|: kernel and plain version
# round P to bf16 against different running maxima, which moves an output by
# about one bf16 ulp, at most 2^-7 of max|ref|
OUT_REL_TOL = 2e-2
LSE_ATOL = 1e-2
KV_TILE = 64  # keys per tile of K1 and K2 (K4's are 128): the planted faults roll rows in these

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
    counter = _counter(name, q.shape[-1])
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


# K7: the same kernels given kv_lens [B]. Lengths cover the whole key range,
# none, a partial last tile and a single key; the suffix past each length
# holds NaN (the kernels never load it; sage_quantize zeroes it by select)
K7_LENS = {(300, 200): [200, 0], (128, 257): [220, 1], (64, 77): [40, 77]}


def _k7_inputs(device, sq, skv, d, fill):
    q, k, v = _qkv(device, sq, skv, d=d, b=2, seed=7)
    lens = torch.tensor(K7_LENS[sq, skv], device=device)
    pad = torch.arange(skv, device=device)[None, :] >= lens[:, None]  # [B, Skv]
    k = k.masked_fill(pad[:, None, :, None], fill)
    v = v.masked_fill(pad[:, None, :, None], fill)
    return q, k, v, lens


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", ["flash", "sage"])
@pytest.mark.parametrize("sq,skv", list(K7_LENS))
def test_k7_matches_plain(cuda, name, d, sq, skv):
    """K7 against its plain version (which reads only the valid keys) with a
    NaN suffix: finite, within the K1/K2 limits, exact zero rows and the
    floored lse -1e4 where a sample has no key, one launch on the varlen
    counter and none on the fixed-length one."""
    kernel, plain = KERNELS[name]
    q, k, v, lens = _k7_inputs(cuda, sq, skv, d, float("nan"))
    counter = _counter(name, d, varlen=True)
    fixed = _counter(name, d)
    before = getattr(kernel, counter), getattr(kernel, fixed)
    out, lse = kernel(q, k, v, kv_lens=lens)
    torch.cuda.synchronize()
    assert (getattr(kernel, counter), getattr(kernel, fixed)) == (before[0] + 1, before[1])
    ref_out, ref_lse = plain(q, k, v, kv_lens=lens)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0,
                               atol=OUT_REL_TOL * ref_out.float().abs().max().item())
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    for b, n in enumerate(lens.tolist()):
        if n == 0:
            assert torch.equal(out[b], torch.zeros_like(out[b]))
            torch.testing.assert_close(lse[b], torch.full_like(lse[b], -1e4), atol=1e-2, rtol=0)


@pytest.mark.parametrize("name", ["flash", "sage"])
def test_k7_limit_catches_a_kernel_without_kv_lens(cuda, name):
    """A planted fault: the kernel run without kv_lens on the same inputs
    (a suffix of 1e4, finite) must break the out limit."""
    kernel, plain = KERNELS[name]
    q, k, v, lens = _k7_inputs(cuda, 128, 257, 128, 1e4)
    ref = plain(q, k, v, kv_lens=lens)[0].float()
    out = kernel(q, k, v)[0].float()
    assert (out - ref).abs().max() > OUT_REL_TOL * ref.abs().max()


def test_k7_rejects_bad_kv_lens(cuda):
    q, k, v = _qkv(cuda, 8, 8, b=2)
    for lens in (torch.tensor([8], device=cuda), torch.tensor([8.0, 8.0], device=cuda)):
        with pytest.raises(ValueError, match="kv_lens"):
            tfa.flash_attention_forward(q, k, v, kv_lens=lens)


# K5: dq, dk and dv each held as max|err| / max|ref|. Kernel and plain version
# round ds and p to bf16 at the same points from the same out and lse; exp2
# and the summation order differ, which flips a rounding by one bf16 ulp
# (2^-8 relative) now and then, and each output is itself rounded to bf16
GRAD_REL_TOL = 2e-2
Q_TILE = 64  # queries per tile of the dk/dv kernel


def _bwd_inputs(device, sq, skv, d=64, seed=2, b=1, h=2):
    q, k, v = _qkv(device, sq, skv, d=d, b=b, h=h, seed=seed)
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
    counter = tfa.kernel_entry(True, d)[2]  # the wgmma kernels at 64, mma.sync at 32
    before = getattr(tfa.flash_attention_backward, counter)
    got = tfa.flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert getattr(tfa.flash_attention_backward, counter) == before + 1
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


# K7's backward: K5 and K6 given kv_lens, on the NaN suffix of the K7
# forward tests, held to the K5/K6 limit against their plain versions
K7_BWD = {64: ("launches_d64_varlen", "launches_d64", tfa.flash_attention_backward_plain),
          128: ("launches_d128_varlen", "launches_d128", tfa.flash_attention_backward_rows_plain)}


def _k7_bwd_inputs(device, sq, skv, d, fill):
    q, k, v, lens = _k7_inputs(device, sq, skv, d, fill)
    out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=lens)
    dout = torch.randn(q.shape, generator=torch.Generator(device).manual_seed(3),
                       device=device).to(torch.bfloat16)
    return q, k, v, out, lse, dout, lens


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", list(K7_LENS))
def test_k7_backward_matches_plain(cuda, d, sq, skv):
    """K5 (D = 64) and K6 (D = 128) given kv_lens against their plain
    versions: finite with NaN past each length, within the limit, one
    launch on the varlen counter and none on the fixed-length one, exact
    zero dk and dv rows past each length and dq = 0 for a sample with none."""
    *args, lens = _k7_bwd_inputs(cuda, sq, skv, d, float("nan"))
    counter, fixed, plain = K7_BWD[d]
    kernel = tfa.flash_attention_backward
    before = getattr(kernel, counter), getattr(kernel, fixed)
    got = kernel(*args, kv_lens=lens)
    torch.cuda.synchronize()
    assert (getattr(kernel, counter), getattr(kernel, fixed)) == (before[0] + 1, before[1])
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, plain(*args, kv_lens=lens))
    assert max(errs) <= GRAD_REL_TOL, errs
    dq, dk, dv = got
    for b, n in enumerate(lens.tolist()):
        assert not dk[b, :, n:].any() and not dv[b, :, n:].any(), b
        if n == 0:
            assert not dq[b].any()


@pytest.mark.parametrize("d", [64, 128])
def test_k7_backward_limit_catches_a_kernel_without_kv_lens(cuda, d):
    """A planted fault: forward and backward run without kv_lens on a
    suffix of 1e4 must break the limit against the plain K7 backward."""
    q, k, v, out, lse, dout, lens = _k7_bwd_inputs(cuda, 128, 257, d, 1e4)
    ref = K7_BWD[d][2](q, k, v, out, lse, dout, kv_lens=lens)
    out_f, lse_f = tfa.flash_attention_forward(q, k, v)
    errs = _grad_errors(tfa.flash_attention_backward(q, k, v, out_f, lse_f, dout), ref)
    assert max(errs) > GRAD_REL_TOL, errs


# K4 and K6 (and K7 in them) are wgmma kernels over tiles of 128 queries and
# 128 keys (K6's dq pass: 64-key tiles; its dk/dv pass: 64-query tiles), fed
# by TMA from [B*H, S, 128] tensor maps whose out-of-range rows read zeros.
# Their tile edges, at B = 2 and H = 3: a tensor map whose (b, h) stride were
# wrong would read another head's rows there
EDGE_SHAPES = [(127, 129), (128, 128), (129, 255), (255, 257)]
# K7 at the edges of a 128-key tile, the keys past each length NaN
K7_EDGE_LENS = [0, 127, 128, 129]


@pytest.mark.parametrize("sq,skv", EDGE_SHAPES + [(1, 1)])
def test_k4_at_tile_edges(cuda, sq, skv):
    _check("flash", *_qkv(cuda, sq, skv, d=128, b=2, h=3))


@pytest.mark.parametrize("sq,skv", EDGE_SHAPES)
def test_k6_at_tile_edges(cuda, sq, skv):
    args = _bwd_inputs(cuda, sq, skv, d=128, b=2, h=3)
    before = tfa.flash_attention_backward.launches_d128
    got = tfa.flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert tfa.flash_attention_backward.launches_d128 == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, tfa.flash_attention_backward_rows_plain(*args))
    assert max(errs) <= GRAD_REL_TOL, errs


def test_k6_with_one_key(cuda):
    """(Sq, Skv) = (1, 1): with one key p = 1 and out = v, so ds = p (dp -
    delta) is 0 up to the order of two f32 sums, and dq and dk are rounding
    noise on both sides: dv is held to the limit, dq and dk (kernel and
    plain version) to 1e-2 of max|dv|."""
    args = _bwd_inputs(cuda, 1, 1, d=128, b=2, h=3)
    got = tfa.flash_attention_backward(*args)
    torch.cuda.synchronize()
    ref = tfa.flash_attention_backward_rows_plain(*args)
    assert all(torch.isfinite(g).all() for g in got)
    assert _grad_errors(got[2:], ref[2:])[0] <= GRAD_REL_TOL
    scale = ref[2].float().abs().max().item()
    for g in got[:2] + ref[:2]:
        assert g.float().abs().max().item() <= 1e-2 * scale


def _k7_edge_inputs(device, d=128):
    q, k, v = _qkv(device, 200, 257, d=d, b=len(K7_EDGE_LENS), h=3, seed=11)
    lens = torch.tensor(K7_EDGE_LENS, device=device)
    pad = torch.arange(k.shape[2], device=device)[None, :] >= lens[:, None]  # [B, Skv]
    k = k.masked_fill(pad[:, None, :, None], float("nan"))
    v = v.masked_fill(pad[:, None, :, None], float("nan"))
    return q, k, v, lens


def test_k7_forward_at_tile_edges(cuda):
    """K7 in K4 at lengths 0, 127, 128 and 129 of 257 keys, NaN past each:
    finite, within the K4 limits, zero rows and the lse -1e4 at length 0."""
    q, k, v, lens = _k7_edge_inputs(cuda)
    out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=lens)
    torch.cuda.synchronize()
    ref_out, ref_lse = tfa.flash_attention_forward_plain(q, k, v, kv_lens=lens)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0,
                               atol=OUT_REL_TOL * ref_out.float().abs().max().item())
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(lse[0], torch.full_like(lse[0], -1e4), atol=1e-2, rtol=0)


def test_k7_backward_at_tile_edges(cuda):
    """K7's backward in K6 at the same lengths: finite with NaN past each,
    within the limit, exact zero dk and dv rows past each length, dq = 0
    for the sample with none."""
    q, k, v, lens = _k7_edge_inputs(cuda)
    out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=lens)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(12),
                       device=cuda).to(torch.bfloat16)
    args = (q, k, v, out, lse, dout)
    got = tfa.flash_attention_backward(*args, kv_lens=lens)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, tfa.flash_attention_backward_rows_plain(*args, kv_lens=lens))
    assert max(errs) <= GRAD_REL_TOL, errs
    dq, dk, dv = got
    for b, n in enumerate(lens.tolist()):
        assert not dk[b, :, n:].any() and not dv[b, :, n:].any(), b
    assert not dq[0].any()


def test_k6_is_deterministic_with_kv_lens(cuda):
    """K7's backward in K6 sums each gradient in one block (no atomics):
    two runs give the same bits."""
    q, k, v, lens = _k7_edge_inputs(cuda)
    out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=lens)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(13),
                       device=cuda).to(torch.bfloat16)
    first = tfa.flash_attention_backward(q, k, v, out, lse, dout, kv_lens=lens)
    second = tfa.flash_attention_backward(q, k, v, out, lse, dout, kv_lens=lens)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# K1 and K5 at head_dim 64 (and K7 in them) are wgmma kernels too: K1 over
# tiles of 192 queries (three consumer warpgroups of 64) and 128 keys, K5's
# dk/dv pass over 128 keys and 64-query tiles, its dq pass over 128 queries
# and 128-key tiles. Sq and Skv at 1, at both sides of 64, 128 and 192, and
# at 35,552 mod the tiles (mod 192 = 32, mod 128 = 96), at B = 2 and H = 3
D64_EDGE_SHAPES = [(63, 65), (64, 64), (65, 63), (127, 129), (128, 128), (129, 127),
                   (191, 193), (192, 192), (193, 191), (224, 224)]


@pytest.mark.parametrize("sq,skv", D64_EDGE_SHAPES + [(1, 1)])
def test_k1_at_tile_edges(cuda, sq, skv):
    _check("flash", *_qkv(cuda, sq, skv, d=64, b=2, h=3))


@pytest.mark.parametrize("sq,skv", D64_EDGE_SHAPES)
def test_k5_at_tile_edges(cuda, sq, skv):
    args = _bwd_inputs(cuda, sq, skv, d=64, b=2, h=3)
    before = tfa.flash_attention_backward.launches_d64
    got = tfa.flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert tfa.flash_attention_backward.launches_d64 == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, tfa.flash_attention_backward_plain(*args))
    assert max(errs) <= GRAD_REL_TOL, errs


def test_k5_with_one_key(cuda):
    """(Sq, Skv) = (1, 1) at head_dim 64, as ``test_k6_with_one_key``: dv
    held to the limit, dq and dk (kernel and plain version) to 1e-2 of
    max|dv|, both being rounding noise."""
    args = _bwd_inputs(cuda, 1, 1, d=64, b=2, h=3)
    got = tfa.flash_attention_backward(*args)
    torch.cuda.synchronize()
    ref = tfa.flash_attention_backward_plain(*args)
    assert all(torch.isfinite(g).all() for g in got)
    assert _grad_errors(got[2:], ref[2:])[0] <= GRAD_REL_TOL
    scale = ref[2].float().abs().max().item()
    for g in got[:2] + ref[:2]:
        assert g.float().abs().max().item() <= 1e-2 * scale


def test_k7_forward_at_tile_edges_d64(cuda):
    """K7 in K1 at head_dim 64 at lengths 0, 127, 128 and 129 of 257 keys,
    NaN past each: finite, within the K1 limits, zero rows and the lse -1e4
    at length 0, one launch on the varlen counter."""
    q, k, v, lens = _k7_edge_inputs(cuda, d=64)
    before = tfa.flash_attention_forward.launches_d64_varlen
    out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=lens)
    torch.cuda.synchronize()
    assert tfa.flash_attention_forward.launches_d64_varlen == before + 1
    ref_out, ref_lse = tfa.flash_attention_forward_plain(q, k, v, kv_lens=lens)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0,
                               atol=OUT_REL_TOL * ref_out.float().abs().max().item())
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(lse[0], torch.full_like(lse[0], -1e4), atol=1e-2, rtol=0)


def test_k7_backward_at_tile_edges_d64(cuda):
    """K7's backward in K5 at head_dim 64 at the same lengths: finite with
    NaN past each, within the limit, exact zero dk and dv rows past each
    length, dq = 0 for the sample with none."""
    q, k, v, lens = _k7_edge_inputs(cuda, d=64)
    out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=lens)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(12),
                       device=cuda).to(torch.bfloat16)
    args = (q, k, v, out, lse, dout)
    before = tfa.flash_attention_backward.launches_d64_varlen
    got = tfa.flash_attention_backward(*args, kv_lens=lens)
    torch.cuda.synchronize()
    assert tfa.flash_attention_backward.launches_d64_varlen == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, tfa.flash_attention_backward_plain(*args, kv_lens=lens))
    assert max(errs) <= GRAD_REL_TOL, errs
    dq, dk, dv = got
    for b, n in enumerate(lens.tolist()):
        assert not dk[b, :, n:].any() and not dv[b, :, n:].any(), b
    assert not dq[0].any()


def test_k5_is_deterministic_with_kv_lens(cuda):
    """K7's backward in K5 at head_dim 64 sums each gradient in one block
    (no atomics): two runs give the same bits."""
    q, k, v, lens = _k7_edge_inputs(cuda, d=64)
    out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=lens)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(13),
                       device=cuda).to(torch.bfloat16)
    first = tfa.flash_attention_backward(q, k, v, out, lse, dout, kv_lens=lens)
    second = tfa.flash_attention_backward(q, k, v, out, lse, dout, kv_lens=lens)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_d64_never_reaches_the_mma_sync_kernels(cuda):
    """A CUDA call at head_dim 64 launches only the wgmma kernels: the
    mma.sync entries refuse d = 64 and their counters stay."""
    fwd, bwd = tfa.flash_attention_forward, tfa.flash_attention_backward
    counts = (fwd.launches, fwd.launches_varlen, bwd.launches, bwd.launches_varlen)
    q, k, v, out, lse, dout = _bwd_inputs(cuda, 130, 70, d=64)
    lens = torch.tensor([50], device=cuda)
    fwd(q, k, v)
    fwd(q, k, v, kv_lens=lens)
    bwd(q, k, v, out, lse, dout)
    bwd(q, k, v, out, lse, dout, kv_lens=lens)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.launches_varlen, bwd.launches, bwd.launches_varlen) == counts
    from vap_tpu_torch.ops import _build

    lse2 = torch.empty_like(lse)
    err = _build.library("flash_fwd").vap_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse2.data_ptr(), None, 2, 2,
        130, 70, 64, 0.18, torch.cuda.current_stream().cuda_stream)
    assert err != 0


# K2 at head_dim 64 and 128 (and K7 in it) is a wgmma kernel too, with an
# int8 Q K^T: at 64 over tiles of 192 queries and 128 keys, at 128 over 128
# and 128, fed by TMA from [B*H, S, D] int8 and bf16 tensor maps. Sq and Skv
# at both sides of 128 and 192, at 257, and Skv = 1, at B = 2 and 4 with
# H = 3 (a tensor map whose (b, h) stride were wrong would read another
# head's rows there)
K2_EDGE_SHAPES = [(127, 129), (128, 128), (129, 127), (191, 193), (192, 192), (193, 191),
                  (257, 257), (130, 1)]


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("sq,skv", K2_EDGE_SHAPES)
@pytest.mark.parametrize("d", [64, 128])
def test_k2_at_tile_edges(cuda, d, sq, skv, b):
    _check("sage", *_qkv(cuda, sq, skv, d=d, b=b, h=3))


@pytest.mark.parametrize("d", [64, 128])
def test_k7_in_k2_at_tile_edges(cuda, d):
    """K7 in K2 at lengths 0, 127, 128 and 129 of 257 keys, NaN past each:
    finite, within the K2 limits, zero rows and the lse -1e4 at length 0,
    one launch on the varlen counter and one of the pre-pass."""
    q, k, v, lens = _k7_edge_inputs(cuda, d=d)
    kernel = tfa.flash_attention_int8_forward
    before = kernel.launches_varlen, tfa.sage_prepass.launches
    out, lse = kernel(q, k, v, kv_lens=lens)
    torch.cuda.synchronize()
    assert (kernel.launches_varlen, tfa.sage_prepass.launches) == (before[0] + 1, before[1] + 1)
    ref_out, ref_lse = tfa.flash_attention_int8_forward_plain(q, k, v, kv_lens=lens)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0,
                               atol=OUT_REL_TOL * ref_out.float().abs().max().item())
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(lse[0], torch.full_like(lse[0], -1e4), atol=1e-2, rtol=0)


@pytest.mark.parametrize("varlen", [False, True], ids=["fixed", "kv_lens"])
@pytest.mark.parametrize("d", [64, 128])
def test_k2_is_deterministic(cuda, d, varlen):
    """The pre-pass reduces its partials in a fixed order and the forward
    sums each row in one block (no atomics): two launches give the same
    bits (without kv_lens on finite keys: a NaN key reaches every row)."""
    q, k, v, lens = _k7_edge_inputs(cuda, d=d) if varlen else (
        *_qkv(cuda, 200, 257, d=d, b=4, h=3, seed=11), None)
    first = tfa.flash_attention_int8_forward(q, k, v, kv_lens=lens)
    second = tfa.flash_attention_int8_forward(q, k, v, kv_lens=lens)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d", [64, 128])
def test_k2_at_the_int8_extremes(cuda, d):
    """Every |q_i8| = |k_i8| = 127: q of ±1 (s_q = 1/127) and k of ±1 in
    rows of zero mean per channel (the smoothing moves nothing, s_k =
    1/127), so the int32 scores reach ±D * 127^2 where signs agree; held
    against the plain version on the same inputs."""
    rng = np.random.default_rng(d)
    sq, skv = 200, 258
    sign_q = rng.choice(np.array([-1.0, 1.0], np.float32), (2, 3, sq, d))
    half = rng.choice(np.array([-1.0, 1.0], np.float32), (2, 3, skv // 2, d))
    sign_k = np.concatenate([half, -half], axis=2)  # each channel sums to 0
    sign_k[:, :, :8] = sign_q[:, :, :8]  # keys equal to queries: the largest scores
    sign_k[:, :, skv // 2:skv // 2 + 8] = -sign_q[:, :, :8]
    q, k = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (sign_q, sign_k))
    v = _qkv(cuda, sq, skv, d=d, b=2, h=3)[2]
    q_i8, k_i8, _ = tfa.sage_prepass(q, k, d ** -0.5)
    assert bool((q_i8.abs() == 127).all()) and bool((k_i8.abs() == 127).all())
    scores = q_i8[:, :, :8].float() @ k_i8[:, :, :8].float().transpose(-1, -2)
    assert scores.diagonal(dim1=-2, dim2=-1).eq(d * 127 * 127).all()
    _check("sage", q, k, v)


@pytest.mark.parametrize("lens", [None, [300, 0], [263, 1]], ids=["fixed", "empty", "partial"])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_sage_prepass_matches_sage_quantize(cuda, d, lens):
    """The pre-pass kernel against the plain version: q_i8 equal (the
    abs-max is exact, the division IEEE, rounded half to even), sqk within
    rtol 1e-6 and k_i8 within one step (the k mean summed in another
    order); with kv_lens, a NaN suffix past each length reaches nothing."""
    q, k, _ = _qkv(cuda, 200, 300, d=d, b=2, h=3, seed=d)
    k = k * 3 + torch.linspace(-2, 2, d, device=cuda).to(torch.bfloat16)  # channel offsets
    if lens is not None:
        lens = torch.tensor(lens, device=cuda)
        pad = torch.arange(300, device=cuda)[None, :] >= lens[:, None]
        k = k.masked_fill(pad[:, None, :, None], float("nan"))
    before = tfa.sage_prepass.launches
    got = tfa.sage_prepass(q, k, d ** -0.5, lens)
    torch.cuda.synchronize()
    assert tfa.sage_prepass.launches == before + 1
    q_i8, k_i8, sqk = tfa.sage_quantize(q, k, d ** -0.5, lens)
    assert torch.equal(got[0], q_i8)
    assert (got[1].int() - k_i8.int()).abs().max().item() <= 1
    torch.testing.assert_close(got[2], sqk, rtol=1e-6, atol=0)
    assert torch.isfinite(got[2]).all()


@pytest.mark.parametrize("d", [32, 96])
def test_k2_at_head_dims_32_and_96_stays_on_the_mma_sync_kernel(cuda, d):
    """Head_dim 32 and 96 launch sage_fwd.cu's mma.sync kernel (counter
    ``launches_mma``), and its entry refuses 64 and 128, whose instances are
    no longer compiled."""
    kernel = tfa.flash_attention_int8_forward
    counts = kernel.launches, kernel.launches_mma
    _check("sage", *_qkv(cuda, 130, 70, d=d))
    assert (kernel.launches, kernel.launches_mma) == (counts[0], counts[1] + 1)
    from vap_tpu_torch.ops import _build

    q, k, v = _qkv(cuda, 130, 70, d=64)
    q_i8, k_i8, sqk = tfa.sage_prepass(q, k, 0.125)
    out, lse = torch.empty_like(q), torch.empty((1, 2, 130), device=cuda)
    for dd in (64, 128):
        err = _build.library("sage_fwd").vap_sage_fwd(
            q_i8.data_ptr(), k_i8.data_ptr(), sqk.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), None, 2, 2, 130, 70, dd, torch.cuda.current_stream().cuda_stream)
        assert err != 0


# K3, the W8A8 linear: per chunk the int32 product is exact on both sides and
# the f32 steps are the same, uncontracted, in the same order, so the kernel's
# outputs equal its plain version's to the bit. A planted fault is measured
# against one bf16 ulp, 2^-7 of max|ref|
W8A8_REL_TOL = 2.0 ** -7
W8A8_TILE = 128  # the planted fault rolls the weight's rows inside blocks of 128


def _w8a8_inputs(device, m, k, n, bias=True, seed=3):
    from vap_tpu_torch.models.common import quantize_linear_int8

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32) * 2).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((n, k), np.float32) * 0.02).to(device)
    w_i8, s_w = quantize_linear_int8(w)
    b = torch.from_numpy(rng.standard_normal(n, np.float32)).to(device) if bias else None
    return x, w_i8, s_w, b


# K3 on the wgmma main loop (csrc/gemm_sm90.cuh): 128-row tiles in 2-tile
# clusters along M, 192 columns wide, K in 128-byte stages; TMA's zero fill
# makes M, N and K ragged, TMA stores clip the output. Rows around the tile
# and the cluster and the 35,552 rows of a CogVideoX projection (277 tiles
# and a tail of 96); N inside one tile, ragged in a second (128 leaves 64
# columns of the tile past N) and 16 tiles; K of one 128-column chunk, 13
# chunks of 128 (1664), two and eight chunks of 1536.
K3_CASES = ([(300, 256, 128, True), (300, 3072, 384, False), (1, 256, 128, True),
             (129, 12288, 256, True)]
            + [(m, 3072, 384, m % 2 == 1) for m in (127, 128, 255, 256, 257, 35552)]
            + [(257, 1664, n, bias) for n in (128, 384, 3072) for bias in (True, False)]
            + [(129, k, 384, True) for k in (128, 1664, 3072)])


@pytest.mark.parametrize("m,k,n,bias", K3_CASES)
def test_k3_matches_plain(cuda, m, k, n, bias):
    """Equal to the plain version to the bit."""
    from vap_tpu_torch.ops import int8_matmul as ti8

    x, w_i8, s_w, b = _w8a8_inputs(cuda, m, k, n, bias)
    before = ti8.int8_linear_chunk.launches
    out = ti8.int8_linear_chunk(x, w_i8, s_w, b)
    torch.cuda.synchronize()
    assert ti8.int8_linear_chunk.launches == before + 1
    ref = ti8.int8_linear_chunk_plain(x, w_i8, s_w, b)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n) and torch.isfinite(out).all()
    assert torch.equal(out, ref)


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


def _probe_operands(cuda, dtype, m, k, n, seed=5):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        return (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8)).to(cuda)
                for s in ((m, k), (n, k)))
    return (torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda, dtype)
            for s in ((m, k), (n, k)))


# K9/K10 on the same main loop, 256 columns wide: rows around the tile and
# the cluster, N ragged inside a tile (128, 384) and 12 tiles, K of half an
# int8 stage (64: the rest of the box is TMA's zeros), one stage, 13, 24.
# K10 takes M in multiples of 16: it runs the multiple of 16 at or above M.
PROBE_CASES = ([(300, 256, 128), (144, 3072, 384), (16, 64, 256)]
               + [(m, 256, 384) for m in (1, 127, 128, 129, 255, 256, 257)]
               + [(272, 640, n) for n in (128, 384, 3072)]
               + [(144, k, 256) for k in (64, 128, 1664)])


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", PROBE_CASES)
def test_gemm_probe_matches_plain(cuda, trans, dtype, m, k, n):
    from vap_tpu_torch.ops import gemm_probe as gp

    if trans:
        m = -(-m // 16) * 16
    x, w = _probe_operands(cuda, dtype, m, k, n, seed=4)
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
        assert torch.isfinite(out).all()
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


# K3's, K9's and K10's persistent walk and determinism; K10's int8 transpose


def _poisoned(shape, dtype, device):
    """An output buffer poisoned with NaN (int32: 2^31 - 1, which no int8
    product reaches): an element the kernel does not write keeps it."""
    return torch.full(shape, 2 ** 31 - 1 if dtype == torch.int32 else float("nan"), dtype=dtype,
                      device=device)


def test_k3_is_deterministic(cuda):
    from vap_tpu_torch.ops import int8_matmul as ti8

    x, w_i8, s_w, b = _w8a8_inputs(cuda, 300, 3072, 384)
    first = ti8.int8_linear_chunk(x, w_i8, s_w, b)
    assert torch.equal(first, ti8.int8_linear_chunk(x, w_i8, s_w, b))


def test_k3_writes_every_output(cuda):
    """The persistent walk covers every tile: the C entry, given an output
    poisoned with NaN, leaves it equal to the plain version."""
    from vap_tpu_torch.ops import _build
    from vap_tpu_torch.ops import int8_matmul as ti8

    m, k, n = 1000, 1536, 640
    x, w_i8, s_w, b = _w8a8_inputs(cuda, m, k, n)
    out = _poisoned((m, n), torch.bfloat16, cuda)
    x_i8 = torch.empty((m, k), dtype=torch.int8, device=cuda)
    s_x = torch.empty((m, 1), dtype=torch.float32, device=cuda)
    err = _build.library("w8a8").vap_w8a8(
        x.data_ptr(), w_i8.data_ptr(), s_w.data_ptr(), b.data_ptr(), x_i8.data_ptr(),
        s_x.data_ptr(), out.data_ptr(), m, n, k, k, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(out, ti8.int8_linear_chunk_plain(x, w_i8, s_w, b))


PROBE_FORMS = [(False, torch.int8), (False, torch.bfloat16), (True, torch.int8),
               (True, torch.bfloat16)]


@pytest.mark.parametrize("trans,dtype", PROBE_FORMS)
def test_gemm_probe_is_deterministic(cuda, trans, dtype):
    from vap_tpu_torch.ops import gemm_probe as gp

    x, w = _probe_operands(cuda, dtype, 1040, 768, 640)
    a = x.T.contiguous() if trans else x
    kernel = gp.gemm_probe_t if trans else gp.gemm_probe
    assert torch.equal(kernel(a, w), kernel(a, w))


@pytest.mark.parametrize("trans,dtype", [(False, torch.int8), (False, torch.bfloat16),
                                         (True, torch.bfloat16)])
def test_gemm_probe_writes_every_output(cuda, trans, dtype):
    """The C entry, given an output poisoned with NaN, leaves it equal to the
    plain version: the persistent walk covers every tile (K10 in int8 is
    K9's kernel after the transpose, so only bf16 runs it transposed)."""
    from vap_tpu_torch.ops import _build
    from vap_tpu_torch.ops import gemm_probe as gp

    m, k, n = 1040, 768, 640
    x, w = _probe_operands(cuda, dtype, m, k, n)
    a = x.T.contiguous() if trans else x
    int8 = dtype == torch.int8
    out = _poisoned((m, n), torch.int32 if int8 else torch.bfloat16, cuda)
    err = _build.library("gemm_probe").vap_gemm_probe(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, int(not int8), int(trans),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    ref = gp.gemm_probe_plain(x, w)
    if int8:
        assert torch.equal(out, ref)
    else:
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=GEMM_BF16_REL_TOL * ref.float().abs().max().item())


@pytest.mark.parametrize("rows,cols", [(64, 16), (128, 272), (3072, 1040)])
def test_k10_int8_transpose_kernel(cuda, rows, cols):
    """K10 in int8 transposes xt [K, M] into x [M, K] with its own kernel
    before K9's: the result is xt.T, byte for byte."""
    from vap_tpu_torch.ops import _build

    rng = np.random.default_rng(6)
    xt = torch.from_numpy(rng.integers(-128, 128, (rows, cols), dtype=np.int8)).to(cuda)
    x = torch.empty((cols, rows), dtype=torch.int8, device=cuda)
    err = _build.library("gemm_probe").vap_transpose_i8(
        xt.data_ptr(), x.data_ptr(), rows, cols, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(x, xt.T)


def test_gemm_probe_entry_refuses_an_int8_transposed_operand(cuda):
    """8-bit wgmma takes no MN-major operand: the C entry refuses int8 with
    trans_a (the wrapper transposes first)."""
    from vap_tpu_torch.ops import _build

    a = torch.zeros((64, 32), dtype=torch.int8, device=cuda)
    w = torch.zeros((128, 64), dtype=torch.int8, device=cuda)
    out = torch.empty((32, 128), dtype=torch.int32, device=cuda)
    err = _build.library("gemm_probe").vap_gemm_probe(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), 32, 128, 64, 0, 1,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


# K8: K1's and K4's kernel given segment ids. Sample 0 packs three segments;
# sample 1 three on the query side, of which segment 2 has no key, and a
# padded tail on both; in-range query rows are held against the plain
# version, padding rows need only be finite
K8_SHAPES = [(300, 200), (128, 257), (64, 77), (200, 200)]


def _k8_ids(device, s, bounds):
    ids = torch.full((s,), -1, dtype=torch.int32)
    pos = 0
    for g, n in enumerate(bounds):
        ids[pos:pos + n] = g
        pos += n
    return ids.to(device)


def _k8_inputs(device, sq, skv, d):
    q, k, v = _qkv(device, sq, skv, d=d, b=2, seed=8)
    q_ids = torch.stack([_k8_ids(device, sq, [sq // 3, sq // 3, sq - 2 * (sq // 3)]),
                         _k8_ids(device, sq, [sq // 2, sq // 4, sq // 8])])
    kv_ids = torch.stack([_k8_ids(device, skv, [skv // 3, skv // 3, skv - 2 * (skv // 3)]),
                          _k8_ids(device, skv, [skv // 2, skv // 4])])
    return q, k, v, q_ids, kv_ids


def _k8_check(q, k, v, q_ids, kv_ids, out, lse):
    ref_out, ref_lse = tfa.flash_attention_segmented_forward_plain(q, k, v, q_ids, kv_ids, 3)
    rows = q_ids >= 0  # [B, Sq]
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    got, want = out.float().transpose(1, 2)[rows], ref_out.float().transpose(1, 2)[rows]
    torch.testing.assert_close(got, want, rtol=0, atol=OUT_REL_TOL * want.abs().max().item())
    torch.testing.assert_close(lse.transpose(1, 2)[rows], ref_lse.transpose(1, 2)[rows],
                               atol=LSE_ATOL, rtol=0)
    return want


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", K8_SHAPES)
def test_k8_matches_plain(cuda, d, sq, skv):
    """K8 against its plain version on in-range rows, one launch on its own
    counter and none on K1's or K4's; a query whose segment has no key gets
    exact zero rows and the lse -1e4."""
    q, k, v, q_ids, kv_ids = _k8_inputs(cuda, sq, skv, d)
    fn = tfa.flash_attention_segmented_forward
    names = [(fn, "launches_d64"), (fn, "launches_d128"), (fn, "launches"),
             (tfa.flash_attention_forward, "launches_d64"),
             (tfa.flash_attention_forward, "launches_d128")]
    before = [getattr(f, n) for f, n in names]
    out, lse = fn(q, k, v, q_ids, kv_ids, 3)
    torch.cuda.synchronize()
    want = [b + int(f is fn and n == ("launches_d128" if d == 128 else "launches_d64"))
            for (f, n), b in zip(names, before)]
    assert [getattr(f, n) for f, n in names] == want
    _k8_check(q, k, v, q_ids, kv_ids, out, lse)
    empty = q_ids[1] == 2  # sample 1's segment 2 has no key
    assert empty.any() and not out[1][:, empty].any()
    torch.testing.assert_close(lse[1][:, empty], torch.full_like(lse[1][:, empty], -1e4),
                               atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("d", [16, 32, 48, 80, 96, 112])
def test_k8_head_dims(cuda, d):
    q, k, v, q_ids, kv_ids = _k8_inputs(cuda, 130, 70, d)
    _k8_check(q, k, v, q_ids, kv_ids, *tfa.flash_attention_segmented_forward(
        q, k, v, q_ids, kv_ids, 3))


@pytest.mark.parametrize("d", [64, 128])
def test_k8_cross_segment_invariance_bitexact(cuda, d):
    """Segment 1 rewritten with finite values up to 1e4: segment 0's rows do
    not move, to the bit (a cross-segment score is selected to -1e30)."""
    q, k, v, q_ids, kv_ids = _k8_inputs(cuda, 200, 200, d)
    base_out, base_lse = tfa.flash_attention_segmented_forward(q, k, v, q_ids, kv_ids, 3)
    seg1 = (kv_ids == 1)[:, None, :, None]
    q2, k2, v2 = (x.masked_fill(seg1, 1e4 if i != 1 else -1e4) for i, x in enumerate((q, k, v)))
    out, lse = tfa.flash_attention_segmented_forward(q2, k2, v2, q_ids, kv_ids, 3)
    seg0 = q_ids == 0
    assert torch.equal(out.transpose(1, 2)[seg0], base_out.transpose(1, 2)[seg0])
    assert torch.equal(lse.transpose(1, 2)[seg0], base_lse.transpose(1, 2)[seg0])


@pytest.mark.parametrize("d", [64, 128])
def test_k8_limit_catches_a_flipped_key_id(cuda, d):
    """A planted fault: one key moved into another segment must break the out
    limit. The key is the one with the largest score for segment 0's queries,
    so the check does not hang on a lucky draw."""
    q, k, v, q_ids, kv_ids = _k8_inputs(cuda, 200, 200, d)
    ref = tfa.flash_attention_segmented_forward_plain(q, k, v, q_ids, kv_ids, 3)[0].float()
    scores = (q[0].float() @ k[0].float().transpose(-1, -2))[:, q_ids[0] == 0]  # [H, n0, Skv]
    j = int(scores.amax(dim=(0, 1))[kv_ids[0] == 0].argmax())
    flipped = kv_ids.clone()
    flipped[0, j] = 1
    out = tfa.flash_attention_segmented_forward(q, k, v, q_ids, flipped, 3)[0].float()
    rows = (q_ids >= 0)[:, None, :, None]
    assert ((out - ref) * rows).abs().max() > OUT_REL_TOL * (ref * rows).abs().max()


def test_k8_rejects_what_it_does_not_take(cuda):
    q, k, v, q_ids, kv_ids = _k8_inputs(cuda, 64, 64, 64)
    fn = tfa.flash_attention_segmented_forward
    with pytest.raises(ValueError, match="bfloat16"):
        fn(q.float(), k.float(), v.float(), q_ids, kv_ids, 3)
    with pytest.raises(ValueError, match="head_dim"):
        fn(*_qkv(cuda, 8, 8, d=72), q_ids[:1, :8], kv_ids[:1, :8], 3)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        fn(q, k, v, q_ids, kv_ids[:, :10], 3)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mask", ["segments", "kv_lens", "none"])
def test_ring_body_on_one_card_matches_one_kernel_call(cuda, n, mask):
    """The ring body, its blocks handed out by a local rotation, against one
    kernel call over all keys (K8, K7 or K4), within the kernel limits."""
    from vap_tpu_torch.parallel import ring_attention_body

    s = 256
    q, k, v, ids, _ = _k8_inputs(cuda, s, s, 128)
    lens = torch.tensor([s - 37, 0], device=cuda)
    kw = {"segments": dict(q_segment_ids=ids, kv_segment_ids=ids, num_segments=3),
          "kv_lens": dict(kv_lens=lens), "none": {}}[mask]
    if mask == "segments":
        ref = tfa.flash_attention_segmented_forward(q, k, v, ids, ids, 3)
    else:
        ref = tfa.flash_attention_forward(q, k, v, **kw)
    blk = s // n

    def block(x, j, dim=2):  # what rank j holds: a contiguous copy
        return x.narrow(dim, j * blk, blk).contiguous()

    cut = [(block(k, i), block(v, i), block(ids, i, 1)) for i in range(n)]
    outs, lses = [], []
    for my in range(n):
        step = iter(range(1, n))

        def pass_on(blocks, my=my, step=step):
            j = (my - next(step)) % n
            return cut[j][:len(blocks)]

        seg = {} if mask != "segments" else dict(q_seg=block(ids, my, 1), kv_seg=cut[my][2],
                                                 num_segments=3)
        out, lse = ring_attention_body(block(q, my), cut[my][0], cut[my][1], n, my, pass_on,
                                       kv_lens=kw.get("kv_lens"), **seg)
        outs.append(out)
        lses.append(lse)
    out, lse = torch.cat(outs, dim=2), torch.cat(lses, dim=2)
    rows = ((ids >= 0) if mask == "segments" else torch.ones_like(ids, dtype=torch.bool))
    got, want = out.float().transpose(1, 2)[rows], ref[0].float().transpose(1, 2)[rows]
    torch.testing.assert_close(got, want, rtol=0, atol=OUT_REL_TOL * want.abs().max().item())
    torch.testing.assert_close(lse.transpose(1, 2)[rows], ref[1].transpose(1, 2)[rows],
                               atol=LSE_ATOL, rtol=0)
    if mask == "kv_lens":
        assert not out[1].any()


# K8's backward: K5 and K6 given segment ids, on the K8 inputs above with
# dout zero on the padding query rows (their rows are unspecified), held to
# the K5/K6 limit against the plain version
K8_BWD_COUNTERS = {64: "launches_d64_seg", 128: "launches_d128_seg"}


def _k8_bwd_inputs(device, sq, skv, d):
    q, k, v, q_ids, kv_ids = _k8_inputs(device, sq, skv, d)
    out, lse = tfa.flash_attention_segmented_forward(q, k, v, q_ids, kv_ids, 3)
    dout = torch.randn(q.shape, generator=torch.Generator(device).manual_seed(9),
                       device=device).to(torch.bfloat16)
    dout = dout.masked_fill((q_ids < 0)[:, None, :, None], 0)
    return q, k, v, out, lse, dout, q_ids, kv_ids


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", K8_SHAPES)
def test_k8_backward_matches_plain(cuda, d, sq, skv):
    """K5 (D = 64) and K6 (D = 128) given segment ids against
    ``flash_attention_segmented_backward_plain``: within the limit, one
    launch on K8's backward counter and none on the others, dq = 0 for the
    query segment with no key."""
    *args, q_ids, kv_ids = _k8_bwd_inputs(cuda, sq, skv, d)
    kernel = tfa.flash_attention_backward
    names = ("launches", "launches_d64", "launches_d128", "launches_varlen",
             "launches_d64_varlen", "launches_d128_varlen", "launches_seg", "launches_d64_seg",
             "launches_d128_seg")
    before = {n: getattr(kernel, n) for n in names}
    got = kernel(*args, segment_ids=(q_ids, kv_ids, 3))
    torch.cuda.synchronize()
    after = {n: getattr(kernel, n) - before[n] for n in names}
    assert after == {n: int(n == K8_BWD_COUNTERS[d]) for n in names}, after
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, tfa.flash_attention_segmented_backward_plain(*args, q_ids, kv_ids, 3))
    assert max(errs) <= GRAD_REL_TOL, errs
    empty = q_ids[1] == 2  # sample 1's segment 2 has no key
    assert not got[0][1][:, empty].any()


@pytest.mark.parametrize("d", [16, 32, 48, 80, 96, 112])
def test_k8_backward_head_dims(cuda, d):
    *args, q_ids, kv_ids = _k8_bwd_inputs(cuda, 130, 70, d)
    got = tfa.flash_attention_backward(*args, segment_ids=(q_ids, kv_ids, 3))
    errs = _grad_errors(got, tfa.flash_attention_segmented_backward_plain(*args, q_ids, kv_ids, 3))
    assert max(errs) <= GRAD_REL_TOL, errs


@pytest.mark.parametrize("d", [64, 128])
def test_k8_backward_cross_segment_invariance_bitexact(cuda, d):
    """Segment 1's q, k, v and dout rewritten with finite values up to 1e4:
    segment 0's dq, dk and dv do not move, to the bit."""
    q, k, v, out, lse, dout, q_ids, kv_ids = _k8_bwd_inputs(cuda, 200, 200, d)
    seg = (q_ids, kv_ids, 3)
    base = tfa.flash_attention_backward(q, k, v, out, lse, dout, segment_ids=seg)
    seg1 = (kv_ids == 1)[:, None, :, None]
    q2, k2, v2, do2 = (x.masked_fill(seg1, 1e4 if i != 1 else -1e4)
                       for i, x in enumerate((q, k, v, dout)))
    out2, lse2 = tfa.flash_attention_segmented_forward(q2, k2, v2, q_ids, kv_ids, 3)
    got = tfa.flash_attention_backward(q2, k2, v2, out2, lse2, do2, segment_ids=seg)
    for g, r, ids in zip(got, base, (q_ids, kv_ids, kv_ids)):
        rows = ids == 0
        assert torch.equal(g.transpose(1, 2)[rows], r.transpose(1, 2)[rows])


@pytest.mark.parametrize("d", [64, 128])
def test_k8_backward_limit_catches_a_flipped_key_id(cuda, d):
    """A planted fault: the backward given one key moved into another
    segment must break the limit against the plain version with the true
    ids (the key with the largest score for segment 0's queries)."""
    q, k, v, out, lse, dout, q_ids, kv_ids = _k8_bwd_inputs(cuda, 200, 200, d)
    ref = tfa.flash_attention_segmented_backward_plain(q, k, v, out, lse, dout, q_ids, kv_ids, 3)
    scores = (q[0].float() @ k[0].float().transpose(-1, -2))[:, q_ids[0] == 0]
    j = int(scores.amax(dim=(0, 1))[kv_ids[0] == 0].argmax())
    flipped = kv_ids.clone()
    flipped[0, j] = 1
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, segment_ids=(q_ids, flipped, 3))
    assert max(_grad_errors(got, ref)) > GRAD_REL_TOL


def test_k8_function_grads_on_the_card(cuda):
    """``flash_attention_segmented`` under autograd on the card runs K8's
    forward and backward once each, and agrees with autograd through the
    dense form in float32 on in-range rows."""
    from vap_tpu_torch.ops.attention import dense_attention_segmented

    q, k, v, q_ids, kv_ids = _k8_inputs(cuda, 200, 200, 64)
    w = torch.randn(q.shape, device=cuda) * (q_ids >= 0)[:, None, :, None]
    counts = (tfa.flash_attention_segmented_forward.launches_d64,
              tfa.flash_attention_backward.launches_d64_seg)
    grads = []
    for attn, dtype in ((tfa.flash_attention_segmented, torch.bfloat16),
                        (lambda q, k, v, a, b, n: dense_attention_segmented(q, k, v, a, b),
                         torch.float32)):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        (attn(*leaves, q_ids, kv_ids, 3).float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    assert (tfa.flash_attention_segmented_forward.launches_d64,
            tfa.flash_attention_backward.launches_d64_seg) == (counts[0] + 1, counts[1] + 1)
    errs = _grad_errors(*grads)
    assert max(errs) <= GRAD_REL_TOL, errs


# K8's wgmma kernels at head_dim 64 and 128 walk only the tiles whose id
# ranges meet their block's (blocks of 192 or 128 rows, tiles of 64 or 128):
# segment edges at and beside 64, 128 and 192 rows, B = 2 and H = 3 (a
# table or map whose sample stride were wrong would read another sample's
# ids or another head's rows), Sq != Skv and a padded tail
K8_EDGE_IDS = {"q": ([64, 128, 129], [127, 65, 100]), "kv": ([128, 64, 108], [63, 129, 90])}


def _k8_case(device, d, q_ids, kv_ids, num_segments, h=3, seed=11):
    """q, k, v at the ids' shapes, K8's out and lse, dout zero on padding
    query rows."""
    b, sq = q_ids.shape
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32))
                     .to(device, torch.bfloat16) for s in (sq, kv_ids.shape[1],
                                                           kv_ids.shape[1], sq))
    out, lse = tfa.flash_attention_segmented_forward(q, k, v, q_ids, kv_ids, num_segments)
    return q, k, v, out, lse, dout.masked_fill((q_ids < 0)[:, None, :, None], 0)


def _k8_held(q_ids, kv_ids, num_segments, args):
    """K8's forward (in-range rows) and backward against their plain
    versions, within the limits."""
    q, k, v, out, lse, dout = args
    torch.cuda.synchronize()
    ref_out, ref_lse = tfa.flash_attention_segmented_forward_plain(q, k, v, q_ids, kv_ids,
                                                                   num_segments)
    rows = q_ids >= 0
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    got, want = out.float().transpose(1, 2)[rows], ref_out.float().transpose(1, 2)[rows]
    torch.testing.assert_close(got, want, rtol=0, atol=OUT_REL_TOL * want.abs().max().item())
    torch.testing.assert_close(lse.transpose(1, 2)[rows], ref_lse.transpose(1, 2)[rows],
                               atol=LSE_ATOL, rtol=0)
    seg = (q_ids, kv_ids, num_segments)
    got = tfa.flash_attention_backward(*args, segment_ids=seg)
    assert all(torch.isfinite(g).all() for g in got)
    errs = _grad_errors(got, tfa.flash_attention_segmented_backward_plain(*args, *seg))
    assert max(errs) <= GRAD_REL_TOL, errs
    return got


@pytest.mark.parametrize("d", [64, 128])
def test_k8_at_tile_edges(cuda, d):
    q_ids = torch.stack([_k8_ids(cuda, 321, n) for n in K8_EDGE_IDS["q"]])
    kv_ids = torch.stack([_k8_ids(cuda, 300, n) for n in K8_EDGE_IDS["kv"]])
    _k8_held(q_ids, kv_ids, 3, _k8_case(cuda, d, q_ids, kv_ids, 3))


@pytest.mark.parametrize("d", [64, 128])
def test_k8_with_unsorted_ids(cuda, d):
    """Ids drawn at random per row (padding among them): every tile pair
    holds several ids, so every score is compared, and the run of tiles a
    block walks holds tiles that meet none of its ids."""
    gen = torch.Generator().manual_seed(12)
    q_ids = torch.randint(-1, 4, (2, 300), generator=gen).to(cuda, torch.int32)
    kv_ids = torch.randint(-1, 4, (2, 450), generator=gen).to(cuda, torch.int32)
    kv_ids[1, 200:] = 5  # sample 1: tiles past 200 meet no query id
    _k8_held(q_ids, kv_ids, 6, _k8_case(cuda, d, q_ids, kv_ids, 6))


@pytest.mark.parametrize("d", [64, 128])
def test_k8_blocks_with_no_tile_to_walk(cuda, d):
    """Sample 0's first 192 queries (segment 0) have no key and walk no key
    tile: zero rows, the lse -1e4 and dq = 0; its keys 128-255 (segment 2)
    have no query, so that key block walks no query tile: dk = dv = 0."""
    q_ids = torch.stack([_k8_ids(cuda, 384, [192, 192]), _k8_ids(cuda, 384, [384])])
    kv_row = torch.tensor([1] * 128 + [2] * 128 + [1] * 64, dtype=torch.int32, device=cuda)
    kv_ids = torch.stack([kv_row, torch.zeros_like(kv_row)])
    args = _k8_case(cuda, d, q_ids, kv_ids, 3)
    dq, dk, dv = _k8_held(q_ids, kv_ids, 3, args)
    out, lse = args[3], args[4]
    assert not out[0, :, :192].any() and not dq[0, :, :192].any()
    assert torch.equal(lse[0, :, :192], torch.full_like(lse[0, :, :192], -1e4))
    assert not dk[0, :, 128:256].any() and not dv[0, :, 128:256].any()


@pytest.mark.parametrize("sq,skv", [(300, 257), (192, 192), (129, 64)])
@pytest.mark.parametrize("d", [64, 128])
def test_k8_one_segment_is_k1_k4_k5_k6_to_the_bit(cuda, d, sq, skv):
    """Every row in one segment: every tile pair is pure, so K8's kernels
    take K1's / K4's and K5's / K6's path and give their bits."""
    q_ids = torch.zeros((2, sq), dtype=torch.int32, device=cuda)
    kv_ids = torch.zeros((2, skv), dtype=torch.int32, device=cuda)
    q, k, v, out, lse, dout = _k8_case(cuda, d, q_ids, kv_ids, 1)
    ref_out, ref_lse = tfa.flash_attention_forward(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    got = tfa.flash_attention_backward(q, k, v, out, lse, dout, segment_ids=(q_ids, kv_ids, 1))
    want = tfa.flash_attention_backward(q, k, v, out, lse, dout)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("d", [64, 128])
def test_k8_backward_is_deterministic(cuda, d):
    q_ids = torch.stack([_k8_ids(cuda, 321, n) for n in K8_EDGE_IDS["q"]])
    kv_ids = torch.stack([_k8_ids(cuda, 300, n) for n in K8_EDGE_IDS["kv"]])
    args = _k8_case(cuda, d, q_ids, kv_ids, 3)
    seg = (q_ids, kv_ids, 3)
    first = tfa.flash_attention_backward(*args, segment_ids=seg)
    again = tfa.flash_attention_backward(*args, segment_ids=seg)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_k8_tile_sizes_are_the_kernels(cuda):
    """The tile sizes the CPU's copy of the tile rule counts in are those
    the built kernels report."""
    assert tfa.segment_tiles_built() == tfa.SEGMENT_TILES


# K8's walk against the tile rule: (q ids, kv ids, num_segments) by kind,
# each [2, S]: packed segments with Sq != Skv and a padded tail; segment
# edges at and beside 64, 128 and 192 rows; blocks with no tile to walk
K8_WALK_IDS = {
    "packed": (([300, 250, 350], [500, 400]), ([280, 270, 300], [450, 400]), (1000, 900)),
    "edges": (K8_EDGE_IDS["q"], K8_EDGE_IDS["kv"], (321, 300)),
    "lonely": None,
}
# the input a kernel reads in the tiles it walks, poisoned by the check: v
# for the forward, k for the dq kernel, dout for the dk/dv kernel (index in
# _k8_case's tuple)
K8_POISONED = {"fwd": 2, "dq": 1, "dkv": 5}


def _k8_walk_ids(device, kind):
    if kind == "lonely":  # as in test_k8_blocks_with_no_tile_to_walk
        q_ids = torch.stack([_k8_ids(device, 384, [192, 192]), _k8_ids(device, 384, [384])])
        kv_row = torch.tensor([1] * 128 + [2] * 128 + [1] * 64, dtype=torch.int32, device=device)
        return q_ids, torch.stack([kv_row, torch.zeros_like(kv_row)])
    q_bounds, kv_bounds, (sq, skv) = K8_WALK_IDS[kind]
    return (torch.stack([_k8_ids(device, sq, n) for n in q_bounds]),
            torch.stack([_k8_ids(device, skv, n) for n in kv_bounds]))


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("kind", list(K8_WALK_IDS))
@pytest.mark.parametrize("d", [64, 128])
def test_k8_walks_no_tile_outside_the_rule(cuda, d, kind, kernel):
    """The rows of every tile a block's run leaves out (``segment_walk_rounds``
    at the kernel's own tile sizes) set to NaN in the input the kernel reads
    there: the block's rows equal the clean run's to the bit, as a tile the
    kernel loaded and scored would multiply a zero p by NaN. The same NaN in
    the tiles the blocks walk must reach their rows (the check can see)."""
    q_ids, kv_ids = _k8_walk_ids(cuda, kind)
    args = _k8_case(cuda, d, q_ids, kv_ids, 3)
    seg = (q_ids, kv_ids, 3)

    def run(a):
        if kernel == "fwd":
            return tfa.flash_attention_segmented_forward(*a[:3], *seg)
        dq, dk, dv = tfa.flash_attention_backward(*a, segment_ids=seg)
        return (dq,) if kernel == "dq" else (dk, dv)

    def poisoned(rows):
        a = list(args)
        x = K8_POISONED[kernel]
        a[x] = a[x].masked_fill(rows[:, None, :, None], float("nan"))
        return run(a)

    blocks, tiles = (kv_ids, q_ids) if kernel == "dkv" else (q_ids, kv_ids)
    rounds = tfa.segment_walk_rounds(blocks, tiles, *tfa.SEGMENT_TILES[(d, kernel)])
    assert rounds
    clean = run(args)
    for in_round, skipped in rounds:
        for got, want in zip(poisoned(skipped), clean):
            assert torch.equal(got.transpose(1, 2)[in_round], want.transpose(1, 2)[in_round])
        walked = ~skipped & in_round.any(1, keepdim=True)
        if walked.any():
            got = poisoned(walked)[0].transpose(1, 2)[in_round]
            assert not torch.isfinite(got).all()


def ring_backward_on_one_card(q, k, v, out, lse, dout, n, kv_lens=None, ids=None):
    """Every rank's ring backward (``ring_backward_steps``) of an n-rank
    ring, advanced in lockstep on one card: at each pass rank i receives
    what rank i - 1 sent. The ranks' dq, dk and dv concatenated along S."""
    from vap_tpu_torch.parallel import ring_backward_steps

    blk = q.shape[2] // n

    def block(x, j, dim=2):
        return x.narrow(dim, j * blk, blk).contiguous()

    steps = []
    for my in range(n):
        seg = {} if ids is None else dict(q_seg=block(ids, my, 1), kv_seg=block(ids, my, 1),
                                          num_segments=3)
        steps.append(ring_backward_steps(block(q, my), block(k, my), block(v, my),
                                         block(out, my), block(lse, my), block(dout, my), n, my,
                                         kv_lens=kv_lens, **seg))
    sent = [next(s) for s in steps]
    done = [None] * n
    while None in done:
        recv = [sent[(my - 1) % n] for my in range(n)]
        for my, s in enumerate(steps):
            try:
                sent[my] = s.send(recv[my])
            except StopIteration as stop:
                done[my] = stop.value
    return [torch.cat([d[i] for d in done], dim=2) for i in range(3)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mask", ["segments", "kv_lens", "none"])
@pytest.mark.parametrize("d", [64, 128])
def test_ring_body_backward_on_one_card_matches_one_kernel_call(cuda, d, n, mask):
    """The ring backward over n key blocks, its blocks and dk/dv accumulators
    passed on in lockstep, against one backward call over all keys (K8's,
    K7's or the fixed-length one) from the same out and lse."""
    s = 256
    q, k, v, ids, _ = _k8_inputs(cuda, s, s, d)
    lens = torch.tensor([s - 37, 0], device=cuda)
    kw = {"segments": dict(segment_ids=(ids, ids, 3)), "kv_lens": dict(kv_lens=lens),
          "none": {}}[mask]
    if mask == "segments":
        out, lse = tfa.flash_attention_segmented_forward(q, k, v, ids, ids, 3)
    else:
        out, lse = tfa.flash_attention_forward(q, k, v, kv_lens=kw.get("kv_lens"))
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(5),
                       device=cuda).to(torch.bfloat16)
    if mask == "segments":
        dout = dout.masked_fill((ids < 0)[:, None, :, None], 0)
    want = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    got = ring_backward_on_one_card(q, k, v, out, lse, dout, n, kv_lens=kw.get("kv_lens"),
                                    ids=ids if mask == "segments" else None)
    errs = _grad_errors(got, want)
    assert max(errs) <= GRAD_REL_TOL, errs


# K3 at Wan2.1-14B's projection widths: N = 5120 is 26 full 192-column tiles
# and a ragged one of 128; K = 5120 quantises in 1024-column chunks, K =
# 13,824 (the FFN's down projection) in 1536; the text rows of the
# cross-attention's K/V (1024) and an unaligned row count
K3_WAN_CASES = [(m, k, n) for m in (300, 1024) for k, n in ((5120, 5120), (5120, 13824),
                                                          (13824, 5120))]


@pytest.mark.parametrize("m,k,n", K3_WAN_CASES)
def test_k3_at_wan_widths(cuda, m, k, n):
    """Equal to the plain version to the bit, the ragged last column tile
    included."""
    from vap_tpu_torch.ops import int8_matmul as ti8

    x, w_i8, s_w, b = _w8a8_inputs(cuda, m, k, n, bias=m % 2 == 0, seed=6)
    before = ti8.int8_linear_chunk.launches
    out = ti8.int8_linear_chunk(x, w_i8, s_w, b)
    torch.cuda.synchronize()
    assert ti8.int8_linear_chunk.launches == before + 1
    ref = ti8.int8_linear_chunk_plain(x, w_i8, s_w, b)
    assert torch.isfinite(out).all() and torch.equal(out, ref)
    assert torch.equal(out[:, -128:], ref[:, -128:])  # the last, ragged tile at N = 5120


class _Tokenizer:
    """Deterministic character ids, padded with 0 (masked)."""

    def __call__(self, texts, padding=None, max_length=16, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:max_length]):
                ids[i, j] = (ord(ch) * 7 + j) % 127 + 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def small_wan_pipeline(device, **kw):
    """A small Wan VAP pipeline in bf16 with random weights from a seed: one
    128-wide head, so every projection, the image embedder's included,
    tiles to K3's 128 and the attention runs in K4."""
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from vap_tpu_torch.pipelines.wan_i2v_mot import WanVAPPipeline

    gen = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    t_cfg = WanMOTConfig.tiny(num_attention_heads=1, attention_head_dim=128, in_channels=12,
                              out_channels=4, text_dim=32, image_dim=128, added_kv_proj_dim=128,
                              ffn_dim=256)
    clip_cfg = CLIPVisionConfig.tiny(hidden_size=128, intermediate_size=256)
    return WanVAPPipeline(
        build_random(WanTransformer3DMOTModel, t_cfg, device, bf16, gen),
        build_random(AutoencoderKLWan, WanVAEConfig.tiny(), device, bf16, gen),
        build_random(T5EncoderModel, T5Config.tiny(per_layer_relative_bias=True), device, bf16,
                     gen),
        build_random(CLIPVisionModel, clip_cfg, device, bf16, gen),
        _Tokenizer(), dtype=bf16, device=device, **kw)


def small_wan_args(steps):
    rng = np.random.default_rng(0)
    return dict(image=rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, 32, 32, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=32, width=32, num_frames=9,
                num_inference_steps=steps, guidance_scale=5.0, max_sequence_length=16,
                output_type="latent",
                latents=torch.from_numpy(rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)))


# the W8A8 pipeline against the bf16 one: the cosine of the final latents,
# the gate tests/test_int8_linear.py puts on JAX's W8A8 Wan forward
W8A8_MIN_COS = 0.999


def test_small_wan_pipeline_in_w8a8_chunk_form(cuda):
    """All 44 projections in K3 (20 in each MoT block's two branches, 2 in
    each image embedder), 2 steps: K3 launches 88 times, the row form never;
    the latents within the cosine gate of the bf16 pipeline's (0.99980 in
    the same run on the CPU, where K3's plain version runs)."""
    from vap_tpu_torch.models import common as tc
    from vap_tpu_torch.ops import int8_matmul as ti8

    pipe = small_wan_pipeline(cuda)
    want = pipe(**small_wan_args(2))
    names = tc.quantize_transformer_linears(pipe.transformer, act_scale="chunk")
    launches, calls = ti8.int8_linear_chunk.launches, tc.int8_linear_row.calls
    got = pipe(**small_wan_args(2))
    assert len(names) == 44
    assert ti8.int8_linear_chunk.launches - launches == 2 * len(names)
    assert tc.int8_linear_row.calls == calls
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
    assert torch.isfinite(got).all() and cos >= W8A8_MIN_COS, cos


def test_small_wan_pipeline_under_unipc_and_the_step_cache(cuda):
    """UniPC with "uniform:2:1:1" over 4 steps: steps 0, 1 and 3 run the
    transformer (K4: the joint attention and four cross-attentions of each
    MoT block), step 2 reuses step 1's prediction and launches nothing; the latents as the plain dense attention's, within the limit
    chip_smoke.py's small Wan check holds flash to."""
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.ops.schedulers import UniPCScheduler

    pipe = small_wan_pipeline(cuda, scheduler=UniPCScheduler(shift=3.0))
    args = dict(small_wan_args(4), step_cache="uniform:2:1:1")
    with attention_provider("xla"):
        ref = pipe(**args)
    before = tfa.flash_attention_forward.launches_d128
    with attention_provider("flash"):
        got = pipe(**args)
    assert pipe.stage_seconds["computed_steps"] == [0, 1, 3]
    assert (tfa.flash_attention_forward.launches_d128 - before
            == 3 * 5 * pipe.transformer.config.num_layers)
    assert torch.isfinite(got).all() and (got - ref).abs().max().item() <= 0.25
