"""A LLaMA decoder used as a text encoder (llava-llama-3-8b for HunyuanVideo)
in PyTorch.

Port of ``vap_tpu/models/text_encoders/llama.py:26-145`` (``llama_encode``):
causal self-attention with grouped-query heads (32 query heads over 8 key
and value heads at the released size), half-split rotary (rotate_half),
a SwiGLU MLP and RMS norms. The attention is plain PyTorch, as the JAX
function computes it with einsum: f32 scores with the causal and key-padding
bias (each padded query keeps its own position), f32 softmax and P V.
``hidden_layer=-3``, what HunyuanVideo conditions on, returns the un-normed
output of block N - 2 and runs no block after it.

Module attributes follow the HF ``LlamaModel`` state-dict keys
(``layers.{i}.self_attn.q_proj.weight``, ``embed_tokens.weight``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import RMSNorm


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Copied from ``vap_tpu/models/text_encoders/llama.py`` (``LlamaConfig``)."""

    vocab_size: int = 128320
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 8192

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llava_llama_8b(cls, **overrides) -> "LlamaConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "LlamaConfig":
        base = dict(vocab_size=64, hidden_size=24, intermediate_size=48,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, rope_theta=10000.0,
                    max_position_embeddings=32)
        base.update(overrides)
        return cls(**base)


def _rotary(cfg: LlamaConfig, seq_len: int, device=None):
    """(cos, sin) [S, head_dim] float32, the halves repeated (``_rotary``, :84)."""
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2, np.float32) / cfg.head_dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float32), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class _Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, kvd = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim
        self.heads, self.kv_heads = cfg.num_attention_heads, cfg.num_key_value_heads
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, kvd, bias=False)
        self.v_proj = nn.Linear(d, kvd, bias=False)
        self.o_proj = nn.Linear(d, d, bias=False)

    def forward(self, x, cos, sin, bias):
        q = self.q_proj(x).unflatten(-1, (self.heads, -1)).transpose(1, 2)
        k = self.k_proj(x).unflatten(-1, (self.kv_heads, -1)).transpose(1, 2)
        v = self.v_proj(x).unflatten(-1, (self.kv_heads, -1)).transpose(1, 2)
        q = (q.float() * cos + _rotate_half(q.float()) * sin).to(x.dtype)
        k = (k.float() * cos + _rotate_half(k.float()) * sin).to(x.dtype)
        if self.kv_heads != self.heads:  # GQA: repeat each kv head
            rep = self.heads // self.kv_heads
            k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5 + bias
        attn = (torch.softmax(s, dim=-1) @ v.float()).to(x.dtype)
        return self.o_proj(attn.transpose(1, 2).flatten(2))


class _MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, i, bias=False)
        self.up_proj = nn.Linear(d, i, bias=False)
        self.down_proj = nn.Linear(i, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = _Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x, cos, sin, bias):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """``forward(input_ids [B, S], attention_mask [B, S] or None,
    hidden_layer=-1)`` -> hidden states [B, S, D] in the weights' dtype."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([_DecoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                hidden_layer: int = -1) -> torch.Tensor:
        """``hidden_layer=-1`` gives the final-norm output (HF
        last_hidden_state); another negative index addresses HF's
        output_hidden_states (embeds, block_1, ..., block_N), un-normed."""
        s = input_ids.shape[1]
        dev = input_ids.device
        x = self.embed_tokens(input_ids)
        cos, sin = _rotary(self.config, s, dev)
        bias = torch.triu(torch.full((s, s), float("-inf"), device=dev), diagonal=1)[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask > 0, 0.0, float("-inf")).float()
            bias = bias + pad[:, None, None, :]
            # a padded query keeps its own position, so no row is all -inf
            eye = torch.eye(s, dtype=torch.bool, device=dev)[None, None]
            bias = torch.maximum(bias, torch.where(eye, 0.0, float("-inf")))
        n = len(self.layers)
        keep = n if hidden_layer == -1 else n + 1 + hidden_layer
        for layer in self.layers[:max(keep, 0)]:
            x = layer(x, cos, sin, bias)
        return self.norm(x) if hidden_layer == -1 else x
