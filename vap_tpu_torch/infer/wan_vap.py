"""The Wan2.1 VAP pipeline from a checkpoint directory.

Port of ``build_pipeline`` of ``infer/wan_vap.py:16-115``: the transformer,
the VAE, the UMT5 text encoder and the CLIP image encoder of a
diffusers-layout directory (or a cached hub id), as
``infer/cog_vap.py``'s ``build_pipeline`` assembles CogVideoX's; the
FlowMatch scheduler with ``flow_shift``. The image encoder loads in
``dtype_str``, as in JAX. The tokenizer comes from the caller. The command
line is not ported.
"""

from __future__ import annotations

from typing import Any, Optional

from ..models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
from ..models.text_encoders.t5 import T5Config, T5EncoderModel
from ..models.wan.config import WanMOTConfig
from ..models.wan.transformer_mot import WanTransformer3DMOTModel
from ..models.wan.vae import AutoencoderKLWan, WanVAEConfig
from ..ops.schedulers import FlowMatchEulerScheduler
from ..pipelines.cogvideox_i2v_mot import resolve_device
from ..pipelines.wan_i2v_mot import WanVAPPipeline
from .cog_vap import Components, parse_dtype


def build_pipeline(model_path: str, dtype_str: str = "bfloat16", flow_shift: float = 3.0, *,
                   revision: Optional[str] = None, variant: Optional[str] = None,
                   cache_dir: Optional[str] = None,
                   transformer_id: Optional[str] = None, vae_id: Optional[str] = None,
                   text_encoder_id: Optional[str] = None, image_encoder_id: Optional[str] = None,
                   transformer_dtype: Optional[str] = None, vae_dtype: Optional[str] = None,
                   text_encoder_dtype: Optional[str] = None,
                   lora_path: Optional[str] = None, lora_scale: Optional[float] = None,
                   enable_vae_tiling: bool = False, enable_vae_slicing: bool = False,
                   enable_model_offload: bool = False, offload_blocks_chunk: Optional[int] = None,
                   tokenizer: Any = None, device: Any = "cuda") -> WanVAPPipeline:
    """Assemble the Wan2.1 VAP pipeline from a checkpoint directory or a
    cached hub id; see ``infer/cog_vap.py`` ``build_pipeline``."""
    device = resolve_device(device)
    dtype = parse_dtype(dtype_str)
    t_dtype, vae_dt, txt_dtype = (parse_dtype(d) if d else dtype
                                  for d in (transformer_dtype, vae_dtype, text_encoder_dtype))
    # streamed block offload keeps the whole model in host memory too
    enable_model_offload = enable_model_offload or bool(offload_blocks_chunk)
    src = Components(model_path, revision, variant, cache_dir, device, enable_model_offload)
    transformer = src.load(WanTransformer3DMOTModel, WanMOTConfig, "transformer", transformer_id,
                           t_dtype, release=WanMOTConfig.wan_14b_i2v_vap,
                           lora_path=lora_path, lora_scale=lora_scale)
    parts = dict(
        vae=src.load(AutoencoderKLWan, WanVAEConfig, "vae", vae_id, vae_dt),
        text_encoder=src.load(T5EncoderModel, T5Config, "text_encoder", text_encoder_id,
                              txt_dtype, release=T5Config.umt5_xxl),
        image_encoder=src.load(CLIPVisionModel, CLIPVisionConfig, "image_encoder",
                               image_encoder_id, dtype))
    return WanVAPPipeline(
        transformer=transformer, **parts, tokenizer=tokenizer,
        scheduler=FlowMatchEulerScheduler(shift=flow_shift), dtype=dtype, device=device,
        enable_vae_tiling=enable_vae_tiling, enable_vae_slicing=enable_vae_slicing,
        enable_model_offload=enable_model_offload, offload_blocks_chunk=offload_blocks_chunk)
