"""T5 v1.1 and UMT5 encoders (T5-XXL for CogVideoX, UMT5-XXL for Wan) in PyTorch.

Port of ``vap_tpu/models/text_encoders/t5.py:26-169``: RMS-norm pre-LN
blocks, a relative position bias, gated-GELU feed-forward, unscaled
attention. T5 v1.1 keeps one bias table (in block 0) shared by all layers;
UMT5 (``per_layer_relative_bias``) has a table in every block and computes
each layer's bias from its own. An optional ``attention_mask`` adds -1e9 to
the scores of padded keys (``t5.py:135-136``); the CogVideoX path
(``cogvideox_i2v_mot.py:167-170``) passes none and keeps all positions.
Attribute names follow HF ``T5EncoderModel`` / ``UMT5EncoderModel``
state-dict keys (``encoder.block.{i}.layer.0.SelfAttention.q.weight``,
``shared.weight``, ...). The ReLU feed-forward is not ported (it raises).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Copied from ``vap_tpu/models/text_encoders/t5.py`` (``T5Config``)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    per_layer_relative_bias: bool = False  # True for UMT5

    @classmethod
    def t5_xxl(cls, **overrides) -> "T5Config":
        return cls(**overrides)

    @classmethod
    def umt5_xxl(cls, **overrides) -> "T5Config":
        base = dict(vocab_size=256384, per_layer_relative_bias=True)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def tiny(cls, **overrides) -> "T5Config":
        base = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
        base.update(overrides)
        return cls(**base)


# --- copied from vap_tpu/models/text_encoders/t5.py (relative_position_bucket)
def relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative position bucketing (host-side)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(n.astype(np.float32) / max_exact + 1e-20) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


class T5LayerNorm(nn.Module):
    """RMS norm; the normed activations are cast to x's dtype before the
    weight multiplies them, as T5 does."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (self.weight.float() * xf.to(x.dtype).float()).to(x.dtype)


class _T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads = cfg.num_heads
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)

    def forward(self, x, bias):
        """x [B, S, d_model]; bias [1 or B, H, S, S] float32."""
        q, k, v = (proj(x).unflatten(-1, (self.heads, -1)).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        scores = q.float() @ k.float().transpose(-1, -2) + bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        return self.o((probs @ v).transpose(1, 2).flatten(2))


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = _T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, h, bias):
        return h + self.SelfAttention(self.layer_norm(h), bias)


class _T5DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _T5DenseGatedGelu(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, h):
        return h + self.DenseReluDense(self.layer_norm(h))


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5LayerSelfAttention(cfg, has_relative_bias), _T5LayerFF(cfg)])

    def forward(self, h, bias):
        return self.layer[1](self.layer[0](h, bias))


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_T5Block(cfg, cfg.per_layer_relative_bias or i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """``forward(input_ids [B, S], attention_mask [B, S] or None)`` ->
    [B, S, d_model] in the weights' dtype."""

    # state-dict key -> checkpoint keys, the first present wins: the
    # embedding is ``shared`` in T5 checkpoints, ``encoder.embed_tokens`` in some
    checkpoint_aliases = {"shared.weight": ("shared.weight", "encoder.embed_tokens.weight")}

    def __init__(self, cfg: T5Config):
        super().__init__()
        if cfg.feed_forward_proj != "gated-gelu":
            raise NotImplementedError("only the gated-GELU feed-forward (T5 v1.1, UMT5) is ported")
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _T5Stack(cfg)

    def position_bias(self, seq_len: int, layer: int = 0) -> torch.Tensor:
        """[1, H, S, S] float32 from the bucket table of block ``layer``."""
        cfg = self.config
        pos = np.arange(seq_len)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        table = self.encoder.block[layer].layer[0].SelfAttention.relative_attention_bias.weight
        idx = torch.from_numpy(buckets).to(table.device)
        return table.float()[idx].permute(2, 0, 1)[None]

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor = None) -> torch.Tensor:
        h = self.shared(input_ids)
        s = input_ids.shape[1]
        mask_bias = None
        if attention_mask is not None:
            mask_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).to(
                device=h.device, dtype=torch.float32)
        per_layer = self.config.per_layer_relative_bias
        for i, block in enumerate(self.encoder.block):
            if i == 0 or per_layer:
                bias = self.position_bias(s, i)
                if mask_bias is not None:
                    bias = bias + mask_bias
            h = block(h, bias)
        return self.encoder.final_layer_norm(h)
