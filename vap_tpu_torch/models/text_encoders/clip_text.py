"""CLIP text encoder (CLIP-L for HunyuanVideo's pooled prompt) in PyTorch.

Port of ``vap_tpu/models/text_encoders/clip_text.py:24-109``
(``clip_text_encode``): token and position embeddings, causal pre-LN
blocks with quick-GELU MLPs, a final layer norm, and the pooled output
taken at the EOS token (at the largest id for legacy configs whose
``eos_token_id`` is 2). The attention is plain PyTorch, f32 scores and
softmax, P cast to the activations' dtype for P V, as the JAX function
computes it. Module attributes follow the HF ``CLIPTextModel`` state-dict
keys (``text_model.encoder.layers.{i}.self_attn.q_proj.weight``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common import layer_norm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """Copied from ``vap_tpu/models/text_encoders/clip_text.py`` (``CLIPTextConfig``)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    hidden_act: str = "quick_gelu"

    @classmethod
    def clip_vit_l(cls, **overrides) -> "CLIPTextConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "CLIPTextConfig":
        base = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                    num_hidden_layers=2, num_attention_heads=2,
                    max_position_embeddings=16, eos_token_id=63)
        base.update(overrides)
        return cls(**base)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new"):
        return F.gelu(x, approximate="tanh" if name == "gelu_new" else "none")
    raise ValueError(name)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, norm.weight, norm.bias, norm.eps)


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))

    def forward(self, x, causal):
        q, k, v = (p(x).unflatten(-1, (self.heads, -1)).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5 + causal
        attn = torch.softmax(s, dim=-1).to(x.dtype)
        return self.out_proj((attn @ v).transpose(1, 2).flatten(2))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x, causal):
        x = x + self.self_attn(_ln(self.layer_norm1, x), causal)
        return x + self.mlp(_ln(self.layer_norm2, x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """``forward(input_ids [B, S])`` -> (last_hidden_state [B, S, D],
    pooled [B, D]) in the weights' dtype."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tm, cfg = self.text_model, self.config
        b, s = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:s]
        causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = _ln(tm.final_layer_norm, x)
        if cfg.eos_token_id == 2:
            # legacy configs: HF pools at the largest id (the real EOT is the
            # vocabulary's last id)
            eos = input_ids.argmax(dim=-1)
        else:
            eos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        return x, x[torch.arange(b, device=x.device), eos]
