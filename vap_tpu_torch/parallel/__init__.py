"""Multi-GPU parallelism of the port: the device mesh and sequence-parallel
attention (``vap_tpu/parallel/``). Parameter sharding (``sharding.py``)
comes with sequence-parallel training."""

from .mesh import AXES, MeshConfig, make_mesh
from .ring_attention import (attention_mesh, get_attention_mesh, ring_attention_body,
                             sequence_parallel_attention)

__all__ = ["AXES", "MeshConfig", "make_mesh", "attention_mesh", "get_attention_mesh",
           "ring_attention_body", "sequence_parallel_attention"]
