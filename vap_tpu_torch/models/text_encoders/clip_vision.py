"""CLIP ViT vision encoder (ViT-H/14 for Wan image-to-video) in PyTorch.

Port of ``vap_tpu/models/text_encoders/clip_vision.py:20-117``: a pre-LN
ViT with a class token and learned position embeddings. Wan conditions on
the penultimate hidden state (257 tokens at 224x224). Its attention is plain
PyTorch, as the JAX function computes it with einsum and not with a kernel.

As in JAX, every weight is cast to the activations' dtype where it is used,
so the encoder computes in the dtype of the pixels it is given (float32 on
the pipeline's path, whatever the weights are stored in). Module attributes
follow the HF ``CLIPVisionModel`` state-dict keys
(``vision_model.encoder.layers.{i}.self_attn.q_proj``, ...).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """Copied from ``vap_tpu/models/text_encoders/clip_vision.py`` (``CLIPVisionConfig``)."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    hidden_act: str = "gelu"  # CLIP-ViT-H; OpenAI CLIP uses "quick_gelu"
    layer_norm_eps: float = 1e-5

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @classmethod
    def tiny(cls, **overrides) -> "CLIPVisionConfig":
        base = dict(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                    num_attention_heads=2, image_size=28, patch_size=14)
        base.update(overrides)
        return cls(**base)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype (the JAX ``layer_norm``)."""
    return F.layer_norm(x.float(), (x.shape[-1],), norm.weight.float(), norm.bias.float(),
                        norm.eps).to(x.dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_linear(p, x).unflatten(-1, (self.heads, -1)).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        scores = (q.float() @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        return _linear(self.out_proj, (attn @ v).transpose(1, 2).flatten(2))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _linear(self.fc1, x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return _linear(self.fc2, h)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.self_attn(_layer_norm(self.layer_norm1, h))
        return h + self.mlp(_layer_norm(self.layer_norm2, h))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.patch_size = cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] -> tokens [B, 1 + (H/p)(W/p), D]."""
        x = pixel_values.permute(0, 3, 1, 2)
        x = F.conv2d(x, self.patch_embedding.weight.to(x.dtype), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight.to(x.dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """``forward(pixel_values [B, H, W, 3], CLIP-normalised)`` -> hidden
    states [B, 257, D], the penultimate layer's output (Wan's choice). The
    last layer and ``post_layernorm`` hold the checkpoint's weights but do
    not run."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.vision_model = _VisionTransformer(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        h = _layer_norm(vm.pre_layrnorm, vm.embeddings(pixel_values))
        for layer in vm.encoder.layers[:-1]:
            h = layer(h)
        return h
