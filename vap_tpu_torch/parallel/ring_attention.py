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

The local kernel (``attention_with_lse``, JAX's ``_local_attention``,
``ring_attention.py:77-90``) is K8 for segment ids, K7 for ``kv_lens`` and
K1/K4 otherwise; on CPU tensors their plain versions; under autograd
through their autograd functions.

How the model meets it: the pipelines and the trainer keep the model
replicated on each rank and call the ``"ring"`` provider with the full q, k
and v (the same seed and inputs on every rank). ``sequence_parallel_attention``
takes this rank's S/n slice of them and of the ids, runs the method, and
all-gathers the output along S, so every rank goes on with the full tensor:
the function JAX's ``shard_map`` computes around a replicated input. At
n = 1 it is the local kernel.

Under autograd (sequence-parallel training) each method's backward runs
the adjoint collectives: allgather computes dq of its queries and dk/dv
contributions for every key, which are summed over the group; ulysses
sends its head-group gradients back with the inverse ``all_to_all``;
ppermute runs the ring backward (``ring_attention_body_backward``), whose
dk/dv accumulators travel with their key block and arrive home after n
steps. Each block's backward (K5/K6, K7 with the block's lengths, K8 with
its ids) takes the merged out and lse. The backward takes this rank's slice
of the full output's gradient and all-gathers dq, dk and dv, so every rank
gets the full gradients, bit-identical on every rank (partial dk and dv are
summed in float32 by the rank that owns the shard, in rank order, then
gathered), and the replicated model's gradients do not drift apart. The
one-rank case goes through the autograd functions of the local kernel.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.flash_attention import (VARLEN_FLOOR_LSE, attention_with_lse, check_segment_args,
                                   flash_attention_backward, segment_ids_int32, wants_grad)

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


def _block_lens(kv_lens, start: int, skv: int):
    """The valid key counts of the key block [start, start + skv):
    clamp(kv_lens - start, 0, skv), or None."""
    if kv_lens is None:
        return None
    return (kv_lens.to(torch.int64) - start).clamp(0, skv)


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
    the floor lse -1e4 and takes no weight. A forward only: the merge does
    not carry the lse's gradient, so under autograd it raises
    (``sequence_parallel_attention`` differentiates, through
    ``ring_attention_body_backward``)."""
    if wants_grad(q, k, v):
        raise RuntimeError("ring_attention_body is a forward: differentiate "
                           "sequence_parallel_attention, whose backward is "
                           "ring_attention_body_backward")
    skv = k.shape[2]
    blocks = (k, v) if kv_seg is None else (k, v, kv_seg)
    acc = lse = None
    for t in range(n):
        if t:
            blocks = pass_on(blocks)
        lens = _block_lens(kv_lens, ((my - t) % n) * skv, skv)
        seg = None if q_seg is None else (q_seg, blocks[2], num_segments)
        out, blk_lse = attention_with_lse(q, blocks[0], blocks[1], scale, lens, seg)
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


def ring_backward_steps(q, k, v, out, lse, dout, n: int, my: int,
                        scale: Optional[float] = None, kv_lens: Optional[torch.Tensor] = None,
                        q_seg: Optional[torch.Tensor] = None,
                        kv_seg: Optional[torch.Tensor] = None,
                        num_segments: Optional[int] = None):
    """The ring backward as a generator, one ``yield`` per pass: it yields
    the tensors this rank sends to rank my + 1 and is sent back those it
    receives from rank my - 1 (``ring_attention_body_backward`` drives it
    with a ``pass_on``; a test on one card can drive n of them in lockstep).
    Its value (``StopIteration.value``) is (dq, dk, dv).

    q, out, dout [B, H, Sq/n, D] and lse [B, H, Sq/n] are this rank's
    queries with the MERGED forward's out and lse (what
    ``ring_attention_body`` returned); k, v [B, H, Skv/n, D] (and
    ``kv_seg``) its own key block. At step t it holds the block that
    started on rank (my - t) mod n with that block's float32 dk and dv
    accumulators, adds the block's backward (K5/K6; K7 with the block's
    clamped lengths; K8 with its ids) to them and to its dq, and passes the
    block and its accumulators on: (k, v[, kv_seg], dk, dv) at steps 1..n-1,
    then the accumulators alone, which arrive home after n passes. dq is
    summed over the n blocks in float32; each is cast once."""
    skv = k.shape[2]
    blocks = (k, v) if kv_seg is None else (k, v, kv_seg)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t in range(n):
        if t:
            *blocks, dk_acc, dv_acc = yield (*blocks, dk_acc, dv_acc)
        lens = _block_lens(kv_lens, ((my - t) % n) * skv, skv)
        seg = None if q_seg is None else (q_seg, blocks[2], num_segments)
        g_q, g_k, g_v = flash_attention_backward(q, blocks[0], blocks[1], out, lse, dout, scale,
                                                 kv_lens=lens, segment_ids=seg)
        dq += g_q.float()
        dk_acc += g_k.float()
        dv_acc += g_v.float()
    dk_acc, dv_acc = yield (dk_acc, dv_acc)
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


def ring_attention_body_backward(q, k, v, out, lse, dout, n: int, my: int,
                                 pass_on: Callable[[Tuple[torch.Tensor, ...]],
                                                   Tuple[torch.Tensor, ...]],
                                 scale: Optional[float] = None,
                                 kv_lens: Optional[torch.Tensor] = None,
                                 q_seg: Optional[torch.Tensor] = None,
                                 kv_seg: Optional[torch.Tensor] = None,
                                 num_segments: Optional[int] = None):
    """The backward of ``ring_attention_body`` on one rank: (dq of its
    queries over all n blocks, dk and dv of its own key block summed over
    every rank's queries), from the merged ``out`` and ``lse`` and this
    rank's ``dout``. ``pass_on`` sends a tuple of tensors to rank my + 1
    and returns the one received from rank my - 1, as in the forward
    (``ring_backward_steps`` says what it carries)."""
    steps = ring_backward_steps(q, k, v, out, lse, dout, n, my, scale, kv_lens, q_seg, kv_seg,
                                num_segments)
    sent = next(steps)
    while True:
        try:
            sent = steps.send(tuple(pass_on(sent)))
        except StopIteration as done:
            return done.value


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


class _Plan(NamedTuple):
    """One call's sharding: the ``seq`` group, its size n and this rank's
    index, the scale, the global ``kv_lens`` and this rank's slice of the
    segment ids ((q_seg, kv_seg, num_segments) or None)."""
    group: Any
    n: int
    my: int
    scale: float
    kv_lens: Optional[torch.Tensor]
    seg: Optional[tuple]

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        size = x.shape[dim] // self.n
        return x.narrow(dim, self.my * size, size).contiguous()

    def ids(self):
        return self.seg if self.seg is not None else (None, None, None)


def _sum_shards(x: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """Every rank's partial [B, H, S, D] summed over the group, this rank's
    S/n shard of it: each shard's n partials arrive at its owner
    (``all_to_all``) and are summed there in float32, in rank order, then
    cast once, so the gathered sum is the same on every rank to the bit."""
    b, h, s, d = x.shape
    recv = _all_to_all(x.reshape(b, h, plan.n, s // plan.n, d).movedim(2, 0), plan.group)
    acc = recv[0].float()
    for part in recv[1:]:
        acc += part.float()
    return acc.to(x.dtype)


# each rotate method: a forward (plan, q, k, v shards) -> (out shard, the
# tensors its backward reads, None where absent) and a backward (plan, those
# tensors, dout shard) -> (dq, dk, dv shards)

def _allgather_fwd(plan, q, k, v):
    seg = plan.seg
    if seg is not None:
        seg = (seg[0], _gather(seg[1], 1, plan.group, plan.n), seg[2])
    kg, vg = _gather(k, 2, plan.group, plan.n), _gather(v, 2, plan.group, plan.n)
    out, lse = attention_with_lse(q, kg, vg, plan.scale, plan.kv_lens, seg)
    return out, (q, kg, vg, out, lse, None if seg is None else seg[1])


def _allgather_bwd(plan, saved, dout):
    """dq of this rank's queries; dk and dv of every key from them, summed
    over the group."""
    q, kg, vg, out, lse, kv_seg = saved
    seg = None if plan.seg is None else (plan.seg[0], kv_seg, plan.seg[2])
    dq, dk, dv = flash_attention_backward(q, kg, vg, out, lse, dout, plan.scale,
                                          kv_lens=plan.kv_lens, segment_ids=seg)
    return dq, _sum_shards(dk, plan), _sum_shards(dv, plan)


def _pass_on(plan):
    """Send a tuple of tensors to rank my + 1 of the group and return the
    one received from rank my - 1."""
    import torch.distributed as dist

    nxt = dist.get_global_rank(plan.group, (plan.my + 1) % plan.n)
    prv = dist.get_global_rank(plan.group, (plan.my - 1) % plan.n)

    def pass_on(blocks: Sequence[torch.Tensor]):
        recv = tuple(torch.empty_like(x) for x in blocks)
        ops = ([dist.P2POp(dist.isend, x.contiguous(), nxt, plan.group) for x in blocks]
               + [dist.P2POp(dist.irecv, x, prv, plan.group) for x in recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    return pass_on


def _ppermute_fwd(plan, q, k, v):
    out, lse = ring_attention_body(q, k, v, plan.n, plan.my, _pass_on(plan), plan.scale,
                                   plan.kv_lens, *plan.ids())
    return out, (q, k, v, out, lse)


def _ppermute_bwd(plan, saved, dout):
    return ring_attention_body_backward(*saved, dout, plan.n, plan.my, _pass_on(plan), plan.scale,
                                        plan.kv_lens, *plan.ids())


def _ulysses_fwd(plan, q, k, v):
    seg = plan.seg
    if seg is not None:
        seg = (_gather(seg[0], 1, plan.group, plan.n), _gather(seg[1], 1, plan.group, plan.n),
               seg[2])
    qh, kh, vh = (_heads_to_seq(x, plan.group, plan.n) for x in (q, k, v))
    out, lse = attention_with_lse(qh, kh, vh, plan.scale, plan.kv_lens, seg)
    ids = (None, None) if seg is None else seg[:2]
    return _seq_to_heads(out, plan.group, plan.n), (qh, kh, vh, out, lse, *ids)


def _ulysses_bwd(plan, saved, dout):
    """The head group's gradients over the whole sequence, sent back with
    the inverse ``all_to_all``."""
    qh, kh, vh, out, lse, q_seg, kv_seg = saved
    seg = None if plan.seg is None else (q_seg, kv_seg, plan.seg[2])
    grads = flash_attention_backward(qh, kh, vh, out, lse, _heads_to_seq(dout, plan.group, plan.n),
                                     plan.scale, kv_lens=plan.kv_lens, segment_ids=seg)
    return tuple(_seq_to_heads(g, plan.group, plan.n) for g in grads)


_METHODS = {"allgather": (_allgather_fwd, _allgather_bwd),
            "ppermute": (_ppermute_fwd, _ppermute_bwd),
            "ulysses": (_ulysses_fwd, _ulysses_bwd)}
ROTATE_METHODS = tuple(_METHODS)


class SequenceParallelAttentionFunction(torch.autograd.Function):
    """``sequence_parallel_attention`` over n > 1 ranks as an autograd
    function: the forward shards the replicated q, k, v, runs the rotate
    method and all-gathers the output; the backward takes this rank's slice
    of the output's gradient, runs the method's adjoint collectives and
    all-gathers dq, dk and dv, the same on every rank.

    Every tensor the backward reads (the method's q, k, v, out and lse, the
    global ``kv_lens`` and this rank's ids) goes through
    ``save_for_backward``; ``ctx`` keeps only the method and the plan's
    other fields. So a non-reentrant ``torch.utils.checkpoint`` around the
    call frees them after the forward and recomputes them, collectives
    included and in the same order on every rank, in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, method: str, plan: _Plan):
        out, saved = _METHODS[method][0](plan, plan.shard(q, 2), plan.shard(k, 2),
                                         plan.shard(v, 2))
        q_seg, kv_seg, ctx.num_segments = plan.ids()
        ctx.save_for_backward(plan.kv_lens, q_seg, kv_seg, *saved)
        ctx.method, ctx.plan = method, plan._replace(kv_lens=None, seg=None)
        return _gather(out, 2, plan.group, plan.n)

    @staticmethod
    def backward(ctx, dout):
        kv_lens, q_seg, kv_seg, *saved = ctx.saved_tensors
        seg = None if q_seg is None else (q_seg, kv_seg, ctx.num_segments)
        plan = ctx.plan._replace(kv_lens=kv_lens, seg=seg)
        grads = _METHODS[ctx.method][1](plan, saved, plan.shard(dout, 2))
        return (*(_gather(g, 2, plan.group, plan.n) for g in grads), None, None)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                                axis: str = "seq", scale: Optional[float] = None,
                                rotate_method: str = "allgather",
                                kv_lens: Optional[torch.Tensor] = None,
                                segment_ids: Optional[tuple] = None) -> torch.Tensor:
    """Attention over the full q [B, H, Sq, D], k and v [B, H, Skv, D]
    (the same on every rank of the mesh), computed with the S axes sharded
    over ``axis``; returns the full output on every rank. Exact for every
    rotate method, and differentiable: under autograd through
    ``SequenceParallelAttentionFunction``, whose gradients are the full
    dq, dk and dv, bit-identical on every rank (module docstring).

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
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:  # the local kernel, through its autograd function under grad
        return attention_with_lse(q, k, v, scale, kv_lens, segment_ids)[0]
    if wants_grad(q, k, v) and q.shape[-1] > 128:
        raise NotImplementedError(
            f"flash attention has no backward at head_dim {q.shape[-1]} (K6 takes 128)")
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
    plan = _Plan(mesh.get_group(axis), n, mesh.get_local_rank(axis), scale, kv_lens, None)
    if segment_ids is not None:
        q_ids, kv_ids, num_segments = segment_ids
        check_segment_args(q, k, q_ids, kv_ids, num_segments)
        plan = plan._replace(seg=(
            plan.shard(segment_ids_int32(q_ids, num_segments, q.device), 1),
            plan.shard(segment_ids_int32(kv_ids, num_segments, q.device), 1), num_segments))
    return SequenceParallelAttentionFunction.apply(q, k, v, rotate_method, plan)
