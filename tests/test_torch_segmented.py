"""K8, the packed-segment attention forward, and the dispatcher's routing of
``segment_ids`` against the JAX package.

K8's plain version (what ``flash_attention_segmented_forward`` runs on CPU
tensors) is held against ``flash_attention_segmented`` with JAX's Pallas
kernels in interpret mode and against ``dense_attention_segmented``, on the
same numpy inputs and the ids of ``tests/test_attention_segmented.py``. The
CUDA kernel is held against this plain version on the card
(``test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vap_tpu.ops.attention import dense_attention_segmented as jax_dense_segmented
from vap_tpu.ops.flash_attention import flash_attention_segmented as jax_segmented
from vap_tpu_torch.ops import attention as tattn
from vap_tpu_torch.ops import flash_attention as tfa

# float32 on both sides: the same softmax over the same keys, summed in
# another order (tiles of 512 keys vs the TPU blocks), as the K1/K4/K7 tests
F32_ATOL = 2e-5
# the lse of a query whose segment has no key: K7's floor
FLOOR_LSE = -1e4


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
def test_k8_under_autograd_raises_naming_the_next_slice(provider):
    """No backward yet: K8 (and the ring provider) raise under autograd, and
    never reach the dense path quietly."""
    q, k, v = (x.requires_grad_() for x in _t(*_qkv(13, 1, 2, 64, 16)))
    ids = torch.from_numpy(_packed_ids(64, [30, 34]))[None]
    with pytest.raises(NotImplementedError, match="K8's backward"):
        tfa.flash_attention_segmented(q, k, v, ids, ids, 2)
    with tattn.attention_provider(provider), pytest.raises(NotImplementedError,
                                                           match="K8's backward"):
        tattn.full_attention(q, k, v, segment_ids=(ids, ids, 2))
    with torch.no_grad():  # the forward itself runs
        assert tfa.flash_attention_segmented(q, k, v, ids, ids, 2).shape == q.shape


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
