"""Sequence-parallel (context-parallel) attention over the ``seq`` axis of a
``DeviceMesh``: port of ``vap_tpu/parallel/ring_attention.py``.

Three ways to share the keys of a sequence cut into n shards along S, as
in JAX (``rotate_method``):

- ``"allgather"`` (default): each rank keeps its S/n queries and gathers
  K and V (and the key segment ids) over the ``seq`` group with
  ``all_gather_into_tensor``, then runs the local kernel over all keys, with
  the global ``kv_lens``.
- ``"ppermute"``: the ring. Each rank holds one K/V block at a time; at
  every step it runs the local kernel on the block it holds, which returns
  (out, lse), and passes the block on to the next rank (i -> i + 1) with
  ``batch_isend_irecv``. The n partial results are merged by their lse in
  float32. JAX's ``_ring_body`` computes the same function with a dense f32
  einsum per block (an [H, S/n, S/n] f32 score tensor, 60 GB per sample at
  n = 2 at full width); here every block goes through the kernel. With
  ``kv_lens`` the block that started on rank (my - t) mod n has the
  lengths clamp(kv_lens - block * S/n, 0, S/n); a block with no valid key
  for a row returns the K7 floor lse -1e4, so it takes no weight in the
  merge, and a row with no valid key in any block is exact zeros.
- ``"ulysses"``: ``all_to_all_single`` from [B, H, S/n, D] to
  [B, H/n, S, D], the ids all-gathered, the local kernel over the full
  sequence on H/n heads, and ``all_to_all_single`` back. Needs H % n == 0.

The local kernel (``_local_attention``) is K8 for segment ids, K7 for
``kv_lens`` and K1/K4 otherwise; on CPU tensors their plain versions.

How the model meets it: the pipelines keep the model replicated on each
rank and call the ``"ring"`` provider with the full q, k and v (the same
seed and inputs on every rank). ``sequence_parallel_attention`` takes this
rank's S/n slice of them and of the ids, runs the method, and all-gathers
the output along S, so every rank goes on with the full tensor: the
function JAX's ``shard_map`` computes around a replicated input. At n = 1
it is the local kernel. Inference only for now: under autograd it raises
(sequence-parallel training, with K8's backward, is the next slice).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..ops.flash_attention import (VARLEN_FLOOR_LSE, check_segment_args,
                                   flash_attention_forward, flash_attention_segmented_forward,
                                   segment_ids_int32, wants_grad)

_ctx = threading.local()


@contextlib.contextmanager
def attention_mesh(mesh, axis: str = "seq", rotate_method: str = "allgather"):
    """Install the mesh the ``"ring"`` attention provider uses in this thread:
    a ``DeviceMesh`` (``make_mesh``), the name of its sequence axis and the
    rotate method ("allgather", "ppermute" or "ulysses")."""
    prev = getattr(_ctx, "mesh_axis", None)
    _ctx.mesh_axis = (mesh, axis, rotate_method)
    try:
        yield
    finally:
        _ctx.mesh_axis = prev


def get_attention_mesh():
    """(mesh, axis, rotate_method) installed by ``attention_mesh``, or None."""
    return getattr(_ctx, "mesh_axis", None)


def _local_attention(q, k, v, scale, kv_lens=None, segment_ids=None):
    """(out, lse) of the local kernel: K8 given segment ids, K7 given
    ``kv_lens``, K1/K4 otherwise (``ring_attention.py:77-90``)."""
    if segment_ids is not None:
        return flash_attention_segmented_forward(q, k, v, *segment_ids, scale)
    return flash_attention_forward(q, k, v, scale, kv_lens)


def ring_attention_body(q, k, v, n: int, my: int,
                        pass_on: Callable[[Tuple[torch.Tensor, ...]], Tuple[torch.Tensor, ...]],
                        scale: Optional[float] = None, kv_lens: Optional[torch.Tensor] = None,
                        q_seg: Optional[torch.Tensor] = None,
                        kv_seg: Optional[torch.Tensor] = None,
                        num_segments: Optional[int] = None):
    """One rank's ring attention over n key blocks: (out, lse) of its
    queries q [B, H, Sq/n, D] against all n blocks of keys.

    It starts with its own block k, v [B, H, Skv/n, D] (and ``kv_seg``
    [B, Skv/n]); before each later step ``pass_on(blocks)`` returns the block
    this rank holds next, where ``blocks`` is (k, v) or (k, v, kv_seg): the
    one that started on rank (my - t) mod n at step t. Across GPUs that is a
    send to rank my + 1 and a receive from rank my - 1; on one card any
    function that hands out the blocks in that order. ``kv_lens`` [B] are
    the global valid key counts; ``q_seg`` [B, Sq/n] are this rank's query
    ids. Each block's (out, lse) from the local kernel is merged into the
    running result by lse, in float32; a block without a key for a row has
    the floor lse -1e4 and takes no weight."""
    skv = k.shape[2]
    blocks = (k, v) if kv_seg is None else (k, v, kv_seg)
    acc = lse = None
    for t in range(n):
        if t:
            blocks = pass_on(blocks)
        lens = None
        if kv_lens is not None:
            start = ((my - t) % n) * skv
            lens = (kv_lens.to(torch.int64) - start).clamp(0, skv)
        seg = None if q_seg is None else (q_seg, blocks[2], num_segments)
        out, blk_lse = _local_attention(q, blocks[0], blocks[1], scale, lens, seg)
        if acc is None:
            acc, lse = out.float(), blk_lse
            continue
        new = torch.logaddexp(lse, blk_lse)
        acc = (acc * torch.exp(lse - new)[..., None]
               + out.float() * torch.exp(blk_lse - new)[..., None])
        lse = new
    # a row with no key in any block: zero out (exact) and, as one kernel
    # call over all keys gives, the floor lse (the merge left it + ln n)
    return acc.to(q.dtype), torch.where(lse < VARLEN_FLOOR_LSE / 2, VARLEN_FLOOR_LSE, lse)


def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """All-gather ``x`` over ``group`` and concatenate the n shards along
    ``dim`` in rank order."""
    import torch.distributed as dist

    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view(n, *x.shape).movedim(0, dim).flatten(dim, dim + 1).contiguous()


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 to rank i; chunk i of the result from rank i."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, H, S/n, D] on every rank -> [B, H/n, S, D]: rank i keeps head
    group i over the whole sequence."""
    b, h, s, d = x.shape
    recv = _all_to_all(x.reshape(b, n, h // n, s, d).transpose(0, 1), group)  # [n: seq block]
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of ``_heads_to_seq``: [B, H/n, S, D] -> [B, H, S/n, D]."""
    b, hn, sn, d = x.shape
    recv = _all_to_all(x.reshape(b, hn, n, sn // n, d).permute(2, 0, 1, 3, 4), group)
    return recv.transpose(0, 1).reshape(b, hn * n, sn // n, d)  # recv [n: head group, ...]


def _allgather(q, k, v, group, n, my, scale, kv_lens, seg):
    if seg is not None:
        seg = (seg[0], _gather(seg[1], 1, group, n), seg[2])
    return _local_attention(q, _gather(k, 2, group, n), _gather(v, 2, group, n), scale,
                            kv_lens, seg)[0]


def _ppermute(q, k, v, group, n, my, scale, kv_lens, seg):
    import torch.distributed as dist

    nxt = dist.get_global_rank(group, (my + 1) % n)
    prv = dist.get_global_rank(group, (my - 1) % n)

    def pass_on(blocks: Sequence[torch.Tensor]):
        recv = tuple(torch.empty_like(x) for x in blocks)
        ops = ([dist.P2POp(dist.isend, x, nxt, group) for x in blocks]
               + [dist.P2POp(dist.irecv, x, prv, group) for x in recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    q_seg, kv_seg, num_segments = seg if seg is not None else (None, None, None)
    return ring_attention_body(q, k, v, n, my, pass_on, scale, kv_lens, q_seg, kv_seg,
                               num_segments)[0]


def _ulysses(q, k, v, group, n, my, scale, kv_lens, seg):
    if seg is not None:
        seg = (_gather(seg[0], 1, group, n), _gather(seg[1], 1, group, n), seg[2])
    qh, kh, vh = (_heads_to_seq(x, group, n) for x in (q, k, v))
    return _seq_to_heads(_local_attention(qh, kh, vh, scale, kv_lens, seg)[0], group, n)


_METHODS = {"allgather": _allgather, "ppermute": _ppermute, "ulysses": _ulysses}
ROTATE_METHODS = tuple(_METHODS)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                                axis: str = "seq", scale: Optional[float] = None,
                                rotate_method: str = "allgather",
                                kv_lens: Optional[torch.Tensor] = None,
                                segment_ids: Optional[tuple] = None) -> torch.Tensor:
    """Attention over the full q [B, H, Sq, D], k and v [B, H, Skv, D]
    (the same on every rank of the mesh), computed with the S axes sharded
    over ``axis``; returns the full output on every rank. Exact for every
    rotate method (module docstring).

    ``kv_lens`` ([B] int): global valid key counts (suffix padding).
    ``segment_ids`` ((q_seg [B, Sq], kv_seg [B, Skv], num_segments)):
    packed sequences, ids sharded with their tokens. The two are mutually
    exclusive. Sq and Skv must divide by the axis size n (give a
    cross-attention site with a short key stream its own provider, e.g.
    "ring cross:flash"), and H too under "ulysses"."""
    if rotate_method not in ROTATE_METHODS:
        raise ValueError(f"unknown rotate_method: {rotate_method!r}")
    if segment_ids is not None and kv_lens is not None:
        raise ValueError("segment_ids and kv_lens are mutually exclusive")
    if wants_grad(q, k, v):
        raise NotImplementedError(
            "sequence-parallel attention has no backward yet: sequence-parallel training, "
            "with K8's backward, is the next slice of the port")
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return _local_attention(q, k, v, scale, kv_lens, segment_ids)[0]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if rotate_method == "ulysses" and q.shape[1] % n != 0:
        raise ValueError(
            f"rotate_method='ulysses' needs the head count divisible by the "
            f"sequence degree: H={q.shape[1]} % {axis}={n} != 0. Use "
            f"'allgather' or 'ppermute' for this config.")
    for name, length in (("query", q.shape[2]), ("key", k.shape[2])):
        if length % n:
            raise ValueError(
                f"sequence-parallel attention shards the {name} length {length} over "
                f"{axis}={n}, which does not divide it; give this call site another "
                f"provider (e.g. 'ring cross:flash')")
    group = mesh.get_group(axis)
    my = mesh.get_local_rank(axis)

    def shard(x: torch.Tensor, dim: int) -> torch.Tensor:
        size = x.shape[dim] // n
        return x.narrow(dim, my * size, size).contiguous()

    seg = None
    if segment_ids is not None:
        q_ids, kv_ids, num_segments = segment_ids
        check_segment_args(q, k, q_ids, kv_ids, num_segments)
        seg = (shard(segment_ids_int32(q_ids, num_segments, q.device), 1),
               shard(segment_ids_int32(kv_ids, num_segments, q.device), 1), num_segments)
    out = _METHODS[rotate_method](shard(q, 2), shard(k, 2), shard(v, 2), group, n, my, scale,
                                  kv_lens, seg)
    return _gather(out, 2, group, n)
