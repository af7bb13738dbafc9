"""Multi-GPU parallelism of the port: the device mesh, sequence-parallel
attention, forward and backward, and parameter sharding (``sharding.py``:
FSDP2 / HSDP over the (data, fsdp) axes) (``vap_tpu/parallel/``). Tensor
parallelism is not ported yet."""

from .mesh import AXES, MeshConfig, make_mesh
from .ring_attention import (ROTATE_METHODS, attention_mesh, get_attention_mesh,
                             ring_attention_body, ring_attention_body_backward,
                             ring_backward_steps, sequence_parallel_attention)

__all__ = ["AXES", "MeshConfig", "make_mesh", "ROTATE_METHODS", "attention_mesh",
           "get_attention_mesh", "ring_attention_body", "ring_attention_body_backward",
           "ring_backward_steps", "sequence_parallel_attention"]
