"""The device mesh: port of ``vap_tpu/parallel/mesh.py:29-59``.

A ``torch.distributed`` ``DeviceMesh`` over the axes (data, fsdp, seq,
tensor) of the JAX package's ``jax.sharding.Mesh``:

  data   — batch data parallelism (DDP)
  fsdp   — parameter sharding (FSDP2); data x fsdp = HSDP
  seq    — sequence (context) parallelism over the joint token stream
  tensor — tensor parallelism

Each axis holds one process group (``mesh.get_group("seq")``). The caller
starts ``torch.distributed`` first, one process per GPU (``torchrun``, or
``init_process_group`` with its address, world size and rank).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

AXES = ("data", "fsdp", "seq", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1

    @property
    def world_size(self) -> int:
        return self.data * self.fsdp * self.seq * self.tensor

    @classmethod
    def for_devices(cls, n: int, *, fsdp: Optional[int] = None, seq: Optional[int] = None,
                    tensor: int = 1) -> "MeshConfig":
        """Heuristic factorization: prefer seq (long joint sequences) then fsdp."""
        remaining = n // tensor
        if seq is None:
            seq = 2 if remaining % 2 == 0 else 1
        remaining //= seq
        if fsdp is None:
            fsdp = 2 if remaining % 2 == 0 else 1
        remaining //= fsdp
        return cls(data=remaining, fsdp=fsdp, seq=seq, tensor=tensor)


def make_mesh(cfg: MeshConfig, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``device_type`` over the first ``cfg.world_size``
    ranks of the default process group, shaped (data, fsdp, seq, tensor).
    Every rank of the group calls it; raises when the world is smaller than
    the config."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed started first "
                           "(init_process_group on every rank)")
    world = dist.get_world_size()
    if world < cfg.world_size:
        raise ValueError(f"need {cfg.world_size} devices, have {world}")
    ranks = torch.arange(cfg.world_size).reshape(cfg.data, cfg.fsdp, cfg.seq, cfg.tensor)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)
