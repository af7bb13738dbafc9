"""vap_tpu_torch — the Video-As-Prompt port to PyTorch and CUDA on NVIDIA Hopper.

A second package beside ``vap_tpu`` (the JAX reference). It imports torch
and never jax. The slice ported so far is single-sample CogVideoX-5B VAP
image-to-video generation (``pipelines.cogvideox_i2v_mot``), with the joint
attention on two hand-written CUDA kernels (``ops.flash_attention``).
"""

__version__ = "0.1.0"
