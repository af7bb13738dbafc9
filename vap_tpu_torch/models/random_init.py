"""Random weights from a seed, in the distribution of the JAX package's
initializers, for runs without a checkpoint (``models/loading.py`` loads
one).

``build_random(cls, cfg, device, dtype, generator)`` constructs a model on
the meta device, allocates it on ``device`` and fills it from
``generator``: the transformers' linears (and their patch convs), CLIP's
and LLaMA's linears uniform +-1/sqrt(fan_in); T5's linears and the VAEs'
convs and linears normal * fan_in^-0.5; zero biases, unit norms, a normal
embedding (0.02-normal for LLaMA and CLIP text, as JAX draws them), a
0.02-normal T5 bias table and CLIP embeddings, normal/sqrt(dim)
scale-shift tables, and the CogVideoX learned position table as its
sincos table.
"""

from __future__ import annotations

import torch
from torch import nn

from .cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel, sincos_pos_embedding
from .common import RMSNorm
from .hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from .loading import build_on_meta
from .text_encoders.clip_text import CLIPTextModel
from .text_encoders.clip_vision import CLIPVisionModel
from .text_encoders.llama import LlamaModel
from .text_encoders.t5 import T5LayerNorm
from .wan.transformer_mot import WanTransformer3DMOTModel
from .wan.vae import RMSNormVideo


def init_random_(model, gen):
    """Fill ``model``'s parameters and buffers from ``gen`` in place."""
    uniform = isinstance(model, (CogVideoXTransformer3DMOTModel, WanTransformer3DMOTModel,
                                 HunyuanVideoTransformer3DModel, CLIPVisionModel, CLIPTextModel,
                                 LlamaModel))
    small_embeddings = isinstance(model, (CLIPTextModel, LlamaModel))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                fan_in = mod.weight[0].numel()
                if uniform:
                    mod.weight.uniform_(-fan_in ** -0.5, fan_in ** -0.5, generator=gen)
                else:
                    mod.weight.normal_(generator=gen).mul_(fan_in ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                if mod.weight is not None:
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            elif isinstance(mod, (T5LayerNorm, RMSNorm)):
                mod.weight.fill_(1.0)
            elif isinstance(mod, RMSNormVideo):
                mod.gamma.fill_(1.0)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(generator=gen)
                if mod.weight.shape[0] < 1000 or small_embeddings:  # T5 bias tables, CLIP, LLaMA
                    mod.weight.mul_(0.02)
        for name, p in model.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).div_(p.shape[-1] ** 0.5)
            elif name.endswith(("class_embedding", "embeddings.patch_embedding.weight")):
                p.normal_(generator=gen).mul_(0.02)
            elif name.endswith("pos_embed"):
                p.zero_()
        if (isinstance(model, CogVideoXTransformer3DMOTModel)
                and model.config.use_learned_positional_embeddings):
            cfg = model.config
            frames = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
            pos = torch.from_numpy(sincos_pos_embedding(cfg, cfg.sample_height,
                                                        cfg.sample_width, frames))
            for pe in (model.patch_embed, model.patch_embed_mot_ref):
                pe.pos_embedding.copy_(pos[None])
    return model


def build_random(cls, cfg, device, dtype, gen, host=False):
    """Construct on the meta device, allocate on ``device``, fill from
    ``gen``; with ``host``, move the weights to host memory afterwards."""
    model = init_random_(build_on_meta(cls, cfg, dtype).to_empty(device=device), gen).eval()
    return model.to("cpu") if host else model
