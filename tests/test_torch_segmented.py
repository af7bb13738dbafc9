"""K8, the packed-segment attention, forward and backward, and the
dispatcher's routing of ``segment_ids`` against the JAX package.

K8's plain versions (what ``flash_attention_segmented_forward`` and
``flash_attention_backward(segment_ids=)`` run on CPU tensors) are held
against ``flash_attention_segmented`` (``jax.vjp`` for the backward) with
JAX's Pallas kernels in interpret mode and against
``dense_attention_segmented``, on the same numpy inputs and the ids of
``tests/test_attention_segmented.py``. The CUDA kernels are held against
these plain versions on the card (``test_torch_gpu.py``, ``chip_smoke.py``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils.checkpoint import checkpoint

from vap_tpu.ops.attention import dense_attention_segmented as jax_dense_segmented
from vap_tpu.ops.flash_attention import flash_attention_segmented as jax_segmented
from vap_tpu_torch.ops import attention as tattn
from vap_tpu_torch.ops import flash_attention as tfa

# float32 on both sides: the same softmax over the same keys, summed in
# another order (tiles of 512 keys vs the TPU blocks), as the K1/K4/K7 tests
F32_ATOL = 2e-5
# the lse of a query whose segment has no key: K7's floor
FLOOR_LSE = -1e4
# gradients, f32, held as max|err| / max(max|ref|, 1) (``BWD_ATOL`` of
# test_torch_varlen.py): the same sums in another order, through P
# recomputed from a saved lse
BWD_ATOL = 1e-4


def _qkv(seed, b, h, sq, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = skv or sq
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, h, skv, d), np.float32),
            rng.standard_normal((b, h, skv, d), np.float32))


def _packed_ids(s, bounds):
    """Contiguous packing: segment g has bounds[g] tokens; the tail after
    sum(bounds) gets the padding id -1."""
    ids = np.full((s,), -1, np.int32)
    pos = 0
    for g, n in enumerate(bounds):
        ids[pos:pos + n] = g
        pos += n
    return ids


def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*map(jnp.asarray, args)))


def _valid(ids, shape):
    """The in-range query rows of an [B, H, Sq, D] output."""
    return np.broadcast_to((ids >= 0)[:, None, :, None], shape)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("d", [64, 128])
def test_k8_plain_matches_jax_segmented(d):
    """D = 64: JAX's one-hots ride free extension rows; D = 128: a second
    depth pass. Both go through ``_flash_attention_forward_t`` in JAX."""
    b, h, s = 2, 2, 640
    q, k, v = _qkv(d, b, h, s, d)
    ids = np.stack([_packed_ids(s, [200, 300, 140]), _packed_ids(s, [512, 100])])
    ref = _interpret(lambda q, k, v, i: jax_segmented(q, k, v, i, i, 3), q, k, v, ids)
    dense = np.asarray(jax_dense_segmented(*map(jnp.asarray, (q, k, v, ids, ids))))
    out, lse = tfa.flash_attention_segmented_forward(*_t(q, k, v, ids, ids), 3)
    valid = _valid(ids, ref.shape)
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy()[valid], dense[valid], atol=F32_ATOL, rtol=0)
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()
    # the lse of an in-range row: the natural-log sum over its segment's keys
    sc = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64) * d ** -0.5
    same = ids[:, :, None] == ids[:, None, :]
    want = np.log(np.where(same[:, None], np.exp(sc), 0.0).sum(-1))
    np.testing.assert_allclose(lse.numpy()[valid[..., 0]], want[valid[..., 0]], atol=F32_ATOL,
                               rtol=0)


def test_k8_plain_matches_jax_cross_attention_ragged_kv():
    """Sq != Skv (packed cross-attention): query segments pick out their own
    key spans."""
    b, h, sq, skv = 2, 2, 384, 640
    q, k, v = _qkv(3, b, h, sq, 64, skv=skv)
    q_ids = np.stack([_packed_ids(sq, [128, 256]), _packed_ids(sq, [300, 84])])
    kv_ids = np.stack([_packed_ids(skv, [400, 240]), _packed_ids(skv, [100, 500])])
    ref = _interpret(lambda q, k, v, a, c: jax_segmented(q, k, v, a, c, 2), q, k, v, q_ids,
                     kv_ids)
    out, _ = tfa.flash_attention_segmented_forward(*_t(q, k, v, q_ids, kv_ids), 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL, rtol=0)


def test_k8_empty_segment_gives_zero_rows_and_the_floor_lse():
    """A query segment with no key on the kv side: exact zero rows and the
    lse -1e4, as K7 gives a sample with no valid key."""
    q, k, v = _qkv(4, 1, 2, 256, 64)
    q_ids = _packed_ids(256, [128, 128])[None]
    kv_ids = _packed_ids(256, [256])[None]  # only segment 0 has keys
    out, lse = tfa.flash_attention_segmented_forward(*_t(q, k, v, q_ids, kv_ids), 2)
    assert np.isfinite(out.numpy()).all()
    assert not out[:, :, 128:].any()
    np.testing.assert_allclose(lse[:, :, 128:].numpy(), FLOOR_LSE, rtol=1e-6)
    dense = np.asarray(jax_dense_segmented(*map(jnp.asarray, (q, k, v, q_ids, kv_ids))))
    np.testing.assert_allclose(out.numpy(), dense, atol=F32_ATOL, rtol=0)


def test_k8_cross_segment_invariance_bitexact():
    """Segment 1's q, k and v rewritten (finite, up to 1e4): segment 0's
    outputs and lse do not move, to the bit. (A NaN would: K8 loads
    cross-segment keys, and 0 * NaN reaches the output, as on the TPU.)"""
    s = 512
    q, k, v = _t(*_qkv(5, 1, 2, s, 64))
    ids = torch.from_numpy(_packed_ids(s, [200, 312]))[None]
    base_out, base_lse = tfa.flash_attention_segmented_forward(q, k, v, ids, ids, 2)
    blast = torch.where((torch.arange(s) >= 200)[None, None, :, None], 1e4, 0.0)
    out, lse = tfa.flash_attention_segmented_forward(q + blast, k - blast, v + blast, ids, ids, 2)
    assert torch.equal(out[:, :, :200], base_out[:, :, :200])
    assert torch.equal(lse[:, :, :200], base_lse[:, :, :200])


def test_k8_out_of_range_ids_are_padding():
    """Ids at or past num_segments, or negative, are padding (-1): masked
    from every in-range query, the in-range rows unchanged."""
    s = 160
    q, k, v = _t(*_qkv(6, 1, 2, s, 32))
    ids = torch.from_numpy(_packed_ids(s, [60, 70]))[None]  # 30 padding tokens (-1)
    other = ids.clone()
    other[0, 130:145] = 2  # out of range for num_segments=2
    other[0, 145:] = -7
    base, _ = tfa.flash_attention_segmented_forward(q, k, v, ids, ids, 2)
    got, _ = tfa.flash_attention_segmented_forward(q, k, v, other, other, 2)
    assert torch.equal(got[:, :, :130], base[:, :, :130])
    assert torch.equal(tfa.segment_ids_int32(other, 2, "cpu"), ids.to(torch.int32))


@pytest.mark.parametrize("provider", ["flash", "flash_varlen", "jax_flash", "sage", "ring"])
def test_segment_ids_route_to_k8(provider):
    """flash, flash_varlen, jax_flash and sage (the bf16 kernel, as JAX
    sends it) run K8; so does ring with no mesh installed: the same output
    as K8's wrapper, to the bit."""
    s = 256
    q, k, v = _t(*_qkv(8, 1, 2, s, 64))
    ids = torch.from_numpy(_packed_ids(s, [100, 156]))[None]
    want, _ = tfa.flash_attention_segmented_forward(q, k, v, ids, ids, 2)
    with tattn.attention_provider(provider):
        got = tattn.full_attention(q, k, v, segment_ids=(ids, ids, 2))
    assert torch.equal(got, want)


def test_xla_segment_ids_route_to_dense_as_in_jax():
    q, k, v = _qkv(9, 2, 2, 96, 16)
    ids = np.stack([_packed_ids(96, [40, 56]), _packed_ids(96, [30, 30, 20])])
    want = np.asarray(jax_dense_segmented(*map(jnp.asarray, (q, k, v, ids, ids))))
    tq, tk, tv, tids = _t(q, k, v, ids)
    with tattn.attention_provider("xla"):
        got = tattn.full_attention(tq, tk, tv, segment_ids=(tids, tids, 3))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    # padding rows too: both compare the raw ids, so sample 1's padding
    # queries attend its padding keys
    np.testing.assert_allclose(tattn.dense_attention_segmented(tq, tk, tv, tids, tids).numpy(),
                               want, atol=F32_ATOL, rtol=0)


def test_null_provider_ignores_segment_ids():
    q, k, v = _t(*_qkv(10, 1, 2, 32, 16))
    ids = torch.zeros((1, 32), dtype=torch.int32)
    with tattn.attention_provider("null"):
        assert torch.equal(tattn.full_attention(q, k, v, segment_ids=(ids, ids, 1)),
                           tattn.full_attention(q, k, v))


def test_segment_args_validated():
    q, k, v = _t(*_qkv(11, 1, 1, 128, 64))
    ids = torch.zeros((1, 128), dtype=torch.int32)
    fn = tfa.flash_attention_segmented
    with pytest.raises(ValueError, match="num_segments"):
        fn(q, k, v, ids, ids, 0)
    with pytest.raises(ValueError, match="num_segments"):
        fn(q, k, v, ids, ids, 1.0)
    with pytest.raises(ValueError, match="q_segment_ids"):
        fn(q, k, v, ids[:, :64], ids, 1)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        fn(q, k, v, ids, ids[None], 1)
    with pytest.raises(ValueError, match="integer"):
        fn(q, k, v, ids.float(), ids, 1)
    with pytest.raises(ValueError, match="integer"):
        fn(q, k, v, ids, ids.bool(), 1)


@pytest.mark.parametrize("provider", ["flash", "xla", "ring"])
def test_segment_ids_and_kv_lens_mutually_exclusive(provider):
    q, k, v = _t(*_qkv(12, 1, 1, 128, 64))
    ids = torch.zeros((1, 128), dtype=torch.int32)
    with tattn.attention_provider(provider), pytest.raises(ValueError,
                                                           match="mutually exclusive"):
        tattn.full_attention(q, k, v, kv_lens=torch.tensor([64]), segment_ids=(ids, ids, 1))


@pytest.mark.parametrize("provider", ["flash", "sage", "ring"])
def test_k8_under_autograd_differentiates_and_raises_only_past_head_dim_128(provider):
    """K8 (and every provider that routes segment ids to it) differentiates
    through ``FlashAttentionSegmentedFunction`` (the same gradients as
    ``flash_attention_segmented``'s, to the bit), never through the dense
    path; only a head_dim with no backward kernel raises, naming K6."""
    q, k, v = (x.requires_grad_() for x in _t(*_qkv(13, 1, 2, 64, 16)))
    ids = torch.from_numpy(_packed_ids(64, [30, 34]))[None]
    w = torch.from_numpy(np.random.default_rng(16).standard_normal((1, 2, 64, 16),
                                                                   np.float32))
    want = torch.autograd.grad((tfa.flash_attention_segmented(q, k, v, ids, ids, 2) * w).sum(),
                               (q, k, v))
    with tattn.attention_provider(provider):
        out = tattn.full_attention(q, k, v, segment_ids=(ids, ids, 2))
    assert out.grad_fn is not None and "Segmented" in type(out.grad_fn).__name__
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    wide = [torch.zeros(1, 1, 8, 192, requires_grad=True) for _ in range(3)]
    ids8 = torch.zeros((1, 8), dtype=torch.int32)
    with tattn.attention_provider(provider), pytest.raises(NotImplementedError,
                                                           match="K6 takes 128"):
        tattn.full_attention(*wide, segment_ids=(ids8, ids8, 1))
    with torch.no_grad():  # the forward itself runs
        assert tfa.flash_attention_segmented(q, k, v, ids, ids, 2).shape == q.shape


# ---------------------------------------------------------------------------
# K8's backward
# ---------------------------------------------------------------------------

def _close_scaled(got, want, name):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=BWD_ATOL * scale, rtol=0, err_msg=name)


def _k8_grads(q, k, v, dout, q_ids, kv_ids, n):
    """The port's K8 forward, then its backward, on CPU tensors (the plain
    versions: K5's form below head_dim 128, K6's at 128)."""
    q, k, v, dout, q_ids, kv_ids = _t(q, k, v, dout, q_ids, kv_ids)
    out, lse = tfa.flash_attention_segmented_forward(q, k, v, q_ids, kv_ids, n)
    return [g.numpy() for g in tfa.flash_attention_backward(q, k, v, out, lse, dout,
                                                            segment_ids=(q_ids, kv_ids, n))]


def _jax_vjp(fn, q, k, v, dout, interpret):
    with pltpu.force_tpu_interpret_mode() if interpret else contextlib.nullcontext():
        _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("d", [64, 128])
def test_k8_backward_plain_matches_jax_vjp(d):
    """``flash_attention_segmented_backward_plain`` against ``jax.vjp`` of
    ``flash_attention_segmented`` (JAX's transposed backward with the
    segment one-hots at both head dims, in interpret mode) and of
    ``dense_attention_segmented``: Sq != Skv, a segment crossing a 64-row
    tile edge, a padded tail and, in sample 1, a query segment (2) with no
    key. dout is zero on the padding query rows, whose rows are unspecified
    (they meet only padding keys here, every key in JAX). The empty
    segment's dq is exactly 0, and so are the dk and dv of keys no query
    shares an id with."""
    b, h, sq, skv = 2, 2, 192, 320
    q, k, v = _qkv(30 + d, b, h, sq, d, skv=skv)
    q_ids = np.stack([_packed_ids(sq, [70, 90, 20]), _packed_ids(sq, [60, 60, 40])])
    kv_ids = np.stack([_packed_ids(skv, [100, 150, 50]), _packed_ids(skv, [200, 100])])
    dout = np.random.default_rng(40 + d).standard_normal(q.shape).astype(np.float32)
    dout *= (q_ids >= 0)[:, None, :, None]
    got = _k8_grads(q, k, v, dout, q_ids, kv_ids, 3)
    ref = _jax_vjp(lambda q, k, v: jax_segmented(q, k, v, jnp.asarray(q_ids),
                                                 jnp.asarray(kv_ids), 3), q, k, v, dout, True)
    dense = _jax_vjp(lambda q, k, v: jax_dense_segmented(q, k, v, jnp.asarray(q_ids),
                                                         jnp.asarray(kv_ids)), q, k, v, dout,
                     False)
    for name, g, r, dn in zip("qkv", got, ref, dense):
        _close_scaled(g, r, f"d{name} vs flash_attention_segmented")
        _close_scaled(g, dn, f"d{name} vs dense_attention_segmented")
    assert not got[0][1, :, 120:160].any()  # sample 1's segment 2 has no key
    assert not got[1][:, :, 300:].any() and not got[2][:, :, 300:].any()  # padding keys
    assert all(np.isfinite(x).all() for x in got)


@pytest.mark.parametrize("d", [64, 128])
def test_k8_backward_cross_segment_invariance_bitexact(d):
    """Segment 1's q, k, v and dout rewritten (finite, up to 1e4): segment
    0's dq, dk and dv do not move, to the bit (a cross-segment pair's p is
    selected to 0, never multiplied)."""
    s = 320
    q, k, v = _t(*_qkv(50 + d, 1, 2, s, d))
    dout = torch.from_numpy(np.random.default_rng(60 + d).standard_normal((1, 2, s, d),
                                                                          np.float32))
    ids = torch.from_numpy(_packed_ids(s, [130, 190]))[None]

    def grads(q, k, v, dout):
        out, lse = tfa.flash_attention_segmented_forward(q, k, v, ids, ids, 2)
        return tfa.flash_attention_backward(q, k, v, out, lse, dout, segment_ids=(ids, ids, 2))

    base = grads(q, k, v, dout)
    blast = torch.where((torch.arange(s) >= 130)[None, None, :, None], 1e4, 0.0)
    got = grads(q + blast, k - blast, v + blast, dout + 3 * blast)
    for g, r in zip(got, base):
        assert torch.equal(g[:, :, :130], r[:, :, :130])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_k8_autograd_matches_dense_autograd(d, remat):
    """``flash_attention_segmented`` under grad
    (``FlashAttentionSegmentedFunction``: K8's forward and backward, plain
    on CPU tensors) against autograd through ``dense_attention_segmented``,
    f32, the loss weighting every in-range output element differently; then
    through a non-reentrant ``torch.utils.checkpoint``, whose recompute must
    carry the ids."""
    b, h, sq, skv = 2, 2, 96, 160
    q, k, v = _t(*_qkv(70 + d, b, h, sq, d, skv=skv))
    q_ids = torch.from_numpy(np.stack([_packed_ids(sq, [40, 50]), _packed_ids(sq, [30, 30, 20])]))
    kv_ids = torch.from_numpy(np.stack([_packed_ids(skv, [64, 90]), _packed_ids(skv, [50, 60, 50])]))
    w = torch.from_numpy(np.random.default_rng(80 + d).standard_normal(q.shape, np.float32))
    w = w * (q_ids >= 0)[:, None, :, None]

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = checkpoint(fn, *leaves, use_reentrant=False) if remat else fn(*leaves)
        (out * w).sum().backward()
        return [x.grad for x in leaves]

    got = grads(lambda q, k, v: tfa.flash_attention_segmented(q, k, v, q_ids, kv_ids, 3))
    want = grads(lambda q, k, v: tattn.dense_attention_segmented(q, k, v, q_ids, kv_ids))
    for name, g, r in zip("qkv", got, want):
        _close_scaled(g.numpy(), r.numpy(), f"d{name}, remat {remat}")


def test_xla_segmented_differentiates_as_jax():
    """The dense form under autograd: its gradients against ``jax.grad`` of
    ``dense_attention_segmented`` on the same inputs."""
    b, h, s, d = 2, 2, 96, 16
    q, k, v = _qkv(14, b, h, s, d)
    ids = np.stack([_packed_ids(s, [40, 56]), _packed_ids(s, [30, 30, 20])])
    w = np.random.default_rng(15).standard_normal((b, h, s, d)).astype(np.float32)
    valid = (ids >= 0).astype(np.float32)[:, None, :, None]

    def jax_loss(q, k, v):
        out = jax_dense_segmented(q, k, v, jnp.asarray(ids), jnp.asarray(ids))
        return jnp.sum(out * w * valid)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tids = torch.from_numpy(ids)
    with tattn.attention_provider("xla"):
        out = tattn.full_attention(tq, tk, tv, segment_ids=(tids, tids, 3))
    (out * torch.from_numpy(w * valid)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# K8's tile rule: which (block, tile) pairs the wgmma kernels walk
# ---------------------------------------------------------------------------

def _rows(mask, block_rows, tile_rows, sb, st_):
    """A [B, blocks, tiles] mask spread over the [B, Sb, St] rows."""
    return (mask.repeat_interleave(block_rows, 1)[:, :sb]
            .repeat_interleave(tile_rows, 2)[:, :, :st_])


@st.composite
def _tile_rule_ids(draw):
    """[B, Sq] and [B, Skv] ids, Sq != Skv in general: sorted (contiguous
    segments, some of length 0, some only on one side, a padded -1 tail) or
    unsorted (an id in [-1, 5) per row)."""
    b = draw(st.integers(1, 2))
    sq, skv = draw(st.integers(1, 420)), draw(st.integers(1, 420))
    if draw(st.booleans()):
        def side(s):
            lengths = draw(st.lists(st.integers(0, 160), min_size=1, max_size=5))
            return [_packed_ids(s, lengths)[:s] for _ in range(b)]
        q, kv = side(sq), side(skv)
    else:
        rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
        q = [rng.integers(-1, 5, sq) for _ in range(b)]
        kv = [rng.integers(-1, 5, skv) for _ in range(b)]
    return (torch.from_numpy(np.stack(q).astype(np.int32)),
            torch.from_numpy(np.stack(kv).astype(np.int32)))


def _check_tile_rule(q_ids, kv_ids):
    """Every equal-id (query, key) pair lies in a kept tile pair and in the
    run each kernel walks, at every block and tile size of the kernels (the
    dk/dv kernel's blocks are key blocks); for sorted ids the run is exactly
    the kept tiles."""
    same = q_ids[:, :, None] == kv_ids[:, None, :]  # [B, Sq, Skv]
    sorted_ids = all(bool((x[:, 1:] >= x[:, :-1]).all()) or x.shape[1] < 2
                     for x in (torch.where(q_ids < 0, 10 ** 6, q_ids),
                               torch.where(kv_ids < 0, 10 ** 6, kv_ids)))
    for (d, kernel), (block_rows, tile_rows) in tfa.SEGMENT_TILES.items():
        blocks, tiles, pairs = ((kv_ids, q_ids, same.transpose(1, 2)) if kernel == "dkv"
                                else (q_ids, kv_ids, same))
        kept = tfa.segment_tiles_kept(blocks, tiles, block_rows, tile_rows)
        walked = tfa.segment_tile_span(blocks, tiles, block_rows, tile_rows)
        assert not (pairs & ~_rows(kept, block_rows, tile_rows, *pairs.shape[1:])).any()
        assert not (kept & ~walked).any()
        if sorted_ids:
            assert torch.equal(kept, walked), (d, kernel)


@settings(max_examples=60, deadline=None)
@given(_tile_rule_ids())
def test_segment_tile_rule_keeps_every_equal_id_pair(ids):
    _check_tile_rule(*ids)


@settings(max_examples=30, deadline=None)
@given(_tile_rule_ids(), st.sampled_from([2, 3, 4]))
def test_segment_tile_rule_on_ring_blocks(ids, n):
    """The ring hands each rank's query block every key block of the same
    stream in turn: the rule holds on every (query block, key block) pair
    of the slices, and for sorted ids a pair of blocks that shares no id
    walks no tile at all, in every kernel."""
    ids = ids[0]
    blk = -(-ids.shape[1] // n)
    is_sorted = bool((torch.where(ids < 0, 10 ** 6, ids).diff(dim=1) >= 0).all())
    for i in range(n):
        for j in range(n):
            q_blk, kv_blk = ids[:, i * blk:(i + 1) * blk], ids[:, j * blk:(j + 1) * blk]
            if q_blk.shape[1] == 0 or kv_blk.shape[1] == 0:
                continue
            _check_tile_rule(q_blk, kv_blk)
            shared = (q_blk[:, :, None] == kv_blk[:, None, :]).any(dim=(1, 2))  # [B]
            for (_, kernel), rows in tfa.SEGMENT_TILES.items():
                pair = (kv_blk, q_blk) if kernel == "dkv" else (q_blk, kv_blk)
                walked = tfa.segment_tile_span(*pair, *rows).flatten(1).any(1)
                if is_sorted:
                    assert torch.equal(walked, shared), (kernel, i, j)


@settings(max_examples=40, deadline=None)
@given(_tile_rule_ids())
def test_segment_walk_rounds_name_each_skipping_block_once(ids):
    """The card's poisoning check (``segment_walk_rounds``) at every
    kernel's tile sizes: each block that skips a tile is in exactly one
    round, with the rows of the tiles its run leaves out; a block that
    walks every tile is in none; and no equal-id pair joins a round's
    block rows and its skipped rows, so what the check poisons moves no
    right output."""
    q_ids, kv_ids = ids
    for (d, kernel), (block_rows, tile_rows) in tfa.SEGMENT_TILES.items():
        blocks, tiles = (kv_ids, q_ids) if kernel == "dkv" else (q_ids, kv_ids)
        span = tfa.segment_tile_span(blocks, tiles, block_rows, tile_rows)
        rounds = tfa.segment_walk_rounds(blocks, tiles, block_rows, tile_rows)
        seen = torch.zeros(span.shape[:2], dtype=torch.int64)
        for in_round, skipped in rounds:
            assert in_round.any() and skipped.any()
            same = blocks[:, :, None] == tiles[:, None, :]
            assert not (same & in_round[:, :, None] & skipped[:, None, :]).any(), (d, kernel)
            for i in range(span.shape[0]):
                members = in_round[i, ::block_rows]
                seen[i] += members
                want = (~span[i, members]).repeat_interleave(tile_rows, 1)[:, :tiles.shape[1]]
                assert (want == skipped[i]).all(), (d, kernel, i)
                assert torch.equal(in_round[i], members.repeat_interleave(block_rows)
                                   [:blocks.shape[1]])
        assert torch.equal(seen, (~span.all(-1)).long()), (d, kernel)


def test_segment_tile_ranges_match_the_rows():
    """Each tile's (least, largest) id over its rows below S, padding after
    every segment; a tile with no row has lo > hi and meets nothing."""
    pad = tfa.SEGMENT_PAD
    ids = torch.from_numpy(np.stack([_packed_ids(200, [70, 0, 90]), _packed_ids(200, [200])]))
    lo, hi = tfa.segment_tile_ranges(ids, 64)
    assert lo.tolist() == [[0, 0, 2, pad], [0, 0, 0, 0]]
    assert hi.tolist() == [[0, 2, pad, pad], [0, 0, 0, 0]]
    lo, hi = tfa.segment_tile_ranges(ids[:, :100], 128)
    assert lo.tolist() == [[0], [0]] and hi.tolist() == [[2], [0]]
    # the padded tail's tile meets segment 2 and padding, not segment 0
    kept = tfa.segment_tiles_kept(ids[:1], ids[:1], 64, 64)[0]
    assert kept[0].tolist() == [True, True, False, False]
    assert kept[3].tolist() == [False, False, True, True]
    none = tfa.segment_tiles_kept(ids[:1, :64], torch.full((1, 64), 7, dtype=torch.int32), 64, 64)
    assert not none.any()

