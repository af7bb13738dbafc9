"""Parameter sharding of the trainer: port of ``vap_tpu/parallel/sharding.py``.

JAX gives every parameter a ``PartitionSpec`` over (data, fsdp, seq,
tensor) and XLA inserts the collectives. The port does the same work with
FSDP2 (``torch.distributed.fsdp.fully_shard``) over the ``(data, fsdp)``
sub-mesh of ``make_mesh``: each transformer block is one unit, the root
(embeddings, time embedding, output head) another. With ``data > 1`` that
is HSDP: every parameter sharded over ``fsdp`` and replicated over
``data``; with ``data = 1``, FSDP. A unit's parameters are gathered for its
forward (and its recompute under remat) in one all-gather and freed
after it; its gradients are reduce-scattered over ``fsdp`` and, under
HSDP, all-reduced over ``data``, FSDP2 dividing by ``data x fsdp``: the
mean over the global batch, since each ``(data, fsdp)`` rank takes
``batch_size`` rows of it (JAX's ``local_batch_size``,
``vap_tpu/training/trainer.py:91-98``). No reduction runs over ``seq``:
the ``seq`` ranks of one group hold the same rows and the ring's backward
gives them the same gradients.

The layout is not JAX's. FSDP2 shards dim 0 of every parameter (an
``nn.Linear`` weight [out, in] by its output rows, a bias or norm too,
where JAX keeps 1-D leaves replicated), padding dim 0 to a multiple of
``fsdp``: a rank holds ``ceil(d0 / fsdp) x prod(rest)`` elements
(``rank_numel``). The numbers computed are the same; ``scripts/
memory_check.py`` holds the bytes a rank keeps against JAX's.

A unit all-gathers its parameters as one buffer: parameters of several
dtypes (float8 storage of the frozen base, bf16 norms, f32 LoRA adapters)
go as bytes. Its trainable parameters must share one dtype, since their
gradients are reduce-scattered as one buffer; ``shard_model`` raises,
naming the unit, where they do not (the control trainer's f32 adapters
beside the bf16 layers it trains directly).

The loss functions call ``prologue`` and ``epilogue`` of the CogVideoX
model as well as its forward; both run under the root unit's gather
(``register_fsdp_forward_method``).

Under ``fsdp x seq`` FSDP2's all-gathers and reduce-scatters run on the
(data, fsdp) groups and the ring's collectives on the seq group: NCCL needs
every rank to issue them in one order, which holds because every rank runs
the same blocks in the same order with the same hooks (no collective waits
on a rank-dependent branch).

The helpers work on a parameter, a gradient or an optimizer state that is
a ``DTensor`` or a plain tensor alike: ``local`` (this rank's elements),
``full_tensor`` (the whole tensor, a collective every rank of the mesh
calls in the same order), ``row_squares`` (per-row sums of squares, one
float a row gathered), ``local_part`` (this rank's piece of a whole
tensor, as ``like`` is placed: no communication), ``shard_like``,
``full_state``.
"""

from __future__ import annotations

from typing import Any, List

import torch
from torch import nn

# the module lists whose entries are the blocks of a ported transformer
BLOCK_LISTS = ("transformer_blocks", "single_transformer_blocks", "blocks")
# the methods the losses call besides forward (CogVideoX's)
FORWARD_METHODS = ("prologue", "epilogue")


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_sharded(t: Any) -> bool:
    return isinstance(t, _dtensor())


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's elements of ``t`` (``t`` itself unless sharded)."""
    return t.to_local() if is_sharded(t) else t


_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t``: an all-gather over the mesh when sharded, which
    every rank must call in the same order (float8 goes as its bytes:
    gloo has no float8 collectives)."""
    if not is_sharded(t):
        return t
    if t.dtype in _FLOAT8:
        raw = _dtensor().from_local(t.to_local().view(torch.uint8), t.device_mesh, t.placements,
                                    run_check=False, shape=t.shape, stride=t.stride())
        return raw.full_tensor().view(t.dtype)
    return t.full_tensor()


def _span(n: int, parts: int, index: int):
    """[start, stop) of piece ``index`` of ``n`` rows cut as ``torch.chunk``
    cuts them, empty pieces at the end (FSDP2's and DTensor's rule)."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(start + size, n)


def local_part(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the whole tensor ``full``, placed as ``like``
    (a view; ``full`` itself when ``like`` is not sharded)."""
    if not is_sharded(like):
        return full
    mesh = like.device_mesh
    out = full
    for dim, placement in enumerate(like.placements):
        if placement.is_shard():
            d = placement.dim
            a, b = _span(full.shape[d], mesh.size(dim), mesh.get_local_rank(dim))
            out = out.narrow(d, a, b - a)
    return out


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` as a tensor placed as ``like``: a ``DTensor`` of this
    rank's piece on ``like``'s device when ``like`` is sharded, else
    ``full`` itself."""
    if not is_sharded(like):
        return full
    piece = local_part(full, like).to(like.device).contiguous()
    return _dtensor().from_local(piece, like.device_mesh, like.placements, run_check=False,
                                 shape=like.shape, stride=like.stride())


def full_state(obj: Any, keep: bool = True) -> Any:
    """``obj`` (a tensor, or dicts and lists of them) with every sharded
    tensor gathered whole: into host memory where ``keep``, else dropped
    (None) once gathered, so that one rank (rank 0, which writes) holds the
    whole state while the others take part in the gathers. Plain tensors
    and other values pass unchanged."""
    if isinstance(obj, dict):
        return {k: full_state(v, keep) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full_state(v, keep) for v in obj)
    if is_sharded(obj):
        whole = full_tensor(obj.detach())
        return whole.cpu() if keep else None
    return obj


def row_squares(t: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares of each dim-0 row of the whole ``t``
    ([d0]; a 0-d ``t`` one row): each rank sums its own rows and the sums
    are all-gathered, one float a row, so that their total is the
    one-process ``row_squares(t).sum()`` to the bit."""
    x = local(t).float()
    rows = x.reshape(x.shape[0] if x.ndim else 1, -1).square().sum(1)
    if not is_sharded(t):
        return rows
    return _dtensor().from_local(rows, t.device_mesh, t.placements, run_check=False,
                                 shape=t.shape[:1], stride=(1,)).full_tensor()


def rank_numel(shape, fsdp: int) -> int:
    """The elements one rank stores of a parameter of ``shape`` sharded by
    FSDP2 over ``fsdp`` ranks: dim 0 padded to a multiple of ``fsdp``."""
    shape = tuple(shape)
    if not shape:
        return 1
    rest = 1
    for d in shape[1:]:
        rest *= d
    return -(-shape[0] // fsdp) * rest


def shard_groups(tensors: List[torch.Tensor]):
    """The process groups over which the sharded ``tensors`` are cut (the
    mesh dims they are ``Shard`` on): a sum over their local elements,
    all-reduced over these groups, is the sum over the whole tensors.
    Raises where the tensors are not all placed alike."""
    sharded = [t for t in tensors if is_sharded(t)]
    if not sharded:
        return []
    mesh, placements = sharded[0].device_mesh, tuple(sharded[0].placements)
    for t in sharded[1:]:
        if t.device_mesh != mesh or tuple(t.placements) != placements:
            raise ValueError("the sharded tensors are not placed on one mesh alike")
    if len(sharded) != len(tensors):
        raise ValueError("some tensors are sharded and some are not")
    return [mesh.get_group(dim) for dim, p in enumerate(placements) if p.is_shard()]


def blocks(model: nn.Module) -> List[nn.Module]:
    """The transformer blocks of ``model``, in order, list by list."""
    out: List[nn.Module] = []
    for name in BLOCK_LISTS:
        out.extend(getattr(model, name, None) or ())
    return out


def _check_trainable_dtypes(module: nn.Module, name: str, skip: set) -> None:
    dtypes = {p.dtype for p in module.parameters() if p.requires_grad and id(p) not in skip}
    if len(dtypes) > 1:
        raise NotImplementedError(
            f"sharding {name}: its trainable parameters are of several dtypes "
            f"({sorted(str(d) for d in dtypes)}); FSDP2 reduce-scatters a unit's gradients as "
            f"one buffer. Training parameters of mixed dtypes under --fsdp_degree is not "
            f"ported (the control trainer's f32 adapters beside its bf16 layers)")


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model`` in place over the ``(data, fsdp)`` axes of ``mesh``
    (a ``make_mesh`` ``DeviceMesh``): ``fully_shard`` each block, then the
    root. Its parameters become ``DTensor`` s (build the optimizer after
    this call, over the model's new parameters). Returns ``model``."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    sub = mesh["data", "fsdp"]
    units = blocks(model)
    seen: set = set()
    for i, block in enumerate(units):
        _check_trainable_dtypes(block, f"block {i}", set())
        seen.update(id(p) for p in block.parameters())
    _check_trainable_dtypes(model, "the root", seen)
    for block in units:
        fully_shard(block, mesh=sub)
    fully_shard(model, mesh=sub)
    for method in FORWARD_METHODS:
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    return model


def rank_of(mesh) -> int:
    """This rank's index among the (data, fsdp) ranks of ``mesh``
    (row-major): whose rows of a global batch it takes."""
    return mesh.get_local_rank("data") * mesh["fsdp"].size() + mesh.get_local_rank("fsdp")
