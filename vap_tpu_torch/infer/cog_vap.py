"""The CogVideoX VAP pipeline from a checkpoint directory.

Port of ``build_pipeline`` of ``infer/cog_vap.py:37-125``: the transformer,
the VAE and the T5 text encoder of a diffusers-layout directory (or a
cached hub id), each component's ``config.json`` layered over the released
configuration, each component's files picked by ``variant``, a PEFT LoRA
fused into the transformer's state dict before it loads. The weights go
onto the card one tensor at a time (``models/loading.py``), or with
``enable_model_offload`` into host memory, one component staged at a time
while the pipeline runs. The tokenizer comes from the caller (``tokenizer=``
or ``pipe.tokenizer``): the port reads no tokenizer files.

    pipe = build_pipeline("Video-As-Prompt-CogVideoX-5B", tokenizer=tok)
    video = pipe(image, prompt, ref_videos=[ref], prompt_mot_ref=[ref_prompt])

The command line (``main`` of the JAX script) is not ported: it needs a
video decoder and tokenizer files.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import torch
from torch import nn

from ..models.cogvideox.config import CogVideoXMOTConfig
from ..models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from ..models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
from ..models.loading import load_model
from ..models.text_encoders.t5 import T5Config, T5EncoderModel
from ..pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline, resolve_device
from ..training.checkpoint import merge_lora_into_state_dict
from ..utils.hub import component_config_kwargs, resolve_model_dir, variant_weight_files
from ..utils.safetensors import SafetensorsDict

DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "fp32": torch.float32,
          "float16": torch.float16, "fp16": torch.float16}


def parse_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(DTYPES)}")
    return DTYPES[name]


class Components:
    """The component directories of one checkpoint: ``root/<name>``, or the
    directory (or cached hub id) that a ``*_id`` override names; each
    component loads onto ``device``, or into host memory with ``host``."""

    def __init__(self, model_path: str, revision: Optional[str], variant: Optional[str],
                 cache_dir: Optional[str], device: torch.device, host: bool):
        self.revision, self.variant, self.cache_dir = revision, variant, cache_dir
        self.device, self.host = device, host
        self.root = resolve_model_dir(model_path, revision, cache_dir)

    def dir(self, name: str, override: Optional[str] = None) -> str:
        return (resolve_model_dir(override, self.revision, self.cache_dir) if override
                else os.path.join(self.root, name))

    def weights(self, name: str, override: Optional[str] = None) -> SafetensorsDict:
        """The component's tensors, every file of the variant (shards too) as
        one mapping of views of the mapped files."""
        return SafetensorsDict(variant_weight_files(self.dir(name, override), self.variant))

    def load(self, cls, cfg_cls, name: str, override: Optional[str], dtype: torch.dtype, *,
             release: Optional[Callable] = None, lora_path: Optional[str] = None,
             lora_scale: Optional[float] = None) -> nn.Module:
        """Component ``name`` as a ``cls`` in ``dtype``: its configuration
        ``release(**fields)`` (``cfg_cls(**fields)`` without a released
        one), the fields of its config.json over the released ones; a PEFT
        LoRA at ``lora_path`` fused into its weights before they load."""
        cfg = (release or cfg_cls)(**component_config_kwargs(cfg_cls, self.dir(name, override)))
        state = self.weights(name, override)
        if lora_path:
            state = merge_lora_into_state_dict(state, lora_path, lora_scale)
        return load_model(cls, cfg, state, self.device, dtype, self.host)


def build_pipeline(model_path: str, dtype_str: str = "bfloat16", *,
                   revision: Optional[str] = None, variant: Optional[str] = None,
                   cache_dir: Optional[str] = None,
                   transformer_id: Optional[str] = None, vae_id: Optional[str] = None,
                   text_encoder_id: Optional[str] = None,
                   transformer_dtype: Optional[str] = None, vae_dtype: Optional[str] = None,
                   text_encoder_dtype: Optional[str] = None,
                   lora_path: Optional[str] = None, lora_scale: Optional[float] = None,
                   enable_vae_tiling: bool = False, enable_vae_slicing: bool = False,
                   enable_model_offload: bool = False,
                   tokenizer: Any = None, device: Any = "cuda") -> CogVideoXVAPPipeline:
    """Assemble the CogVideoX VAP pipeline from a checkpoint directory or a
    cached hub id, with the JAX surface: each ``*_id`` overrides one
    component's source, each ``*_dtype`` its storage dtype (``dtype_str``
    otherwise); ``lora_path`` fuses PEFT-layout adapters into the
    transformer before it loads (``lora_scale``, else alpha / r); the
    ``enable_vae_*`` toggles map to the pipeline's tiled / sliced decode.
    Runs on the card unless ``device`` asks for the CPU."""
    device = resolve_device(device)
    dtype = parse_dtype(dtype_str)
    t_dtype, vae_dt, txt_dtype = (parse_dtype(d) if d else dtype
                                  for d in (transformer_dtype, vae_dtype, text_encoder_dtype))
    src = Components(model_path, revision, variant, cache_dir, device, enable_model_offload)
    transformer = src.load(CogVideoXTransformer3DMOTModel, CogVideoXMOTConfig, "transformer",
                           transformer_id, t_dtype, release=CogVideoXMOTConfig.cogvideox_5b_i2v_vap,
                           lora_path=lora_path, lora_scale=lora_scale)
    vae = src.load(AutoencoderKLCogVideoX, CogVideoXVAEConfig, "vae", vae_id, vae_dt)
    text_encoder = src.load(T5EncoderModel, T5Config, "text_encoder", text_encoder_id, txt_dtype,
                            release=T5Config.t5_xxl)
    return CogVideoXVAPPipeline(
        transformer, vae, text_encoder, tokenizer, dtype=dtype, device=device,
        enable_vae_tiling=enable_vae_tiling, enable_vae_slicing=enable_vae_slicing,
        enable_model_offload=enable_model_offload)
