"""Shared building blocks: fp32 norms, GELU-tanh feed-forward, timestep embedding.

Port of ``vap_tpu/models/common.py:44-55,129+``. Linears are ``nn.Linear``
in the model dtype (bf16 on the main path; the W8A8 path is not ported).
Norms compute in float32 and cast back, as the JAX functions do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def layer_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in float32, cast back to x's dtype."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def rms_norm(x: torch.Tensor, weight, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class FP32LayerNorm(nn.LayerNorm):
    """nn.LayerNorm whose statistics and affine run in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class _GELUProj(nn.Module):
    """diffusers GELU(approximate='tanh') with its ``proj`` linear."""

    def __init__(self, dim: int, inner: int, bias: bool = True):
        super().__init__()
        self.proj = nn.Linear(dim, inner, bias=bias)

    def forward(self, x):
        return gelu_tanh(self.proj(x))


class FeedForward(nn.Module):
    """diffusers FeedForward('gelu-approximate'): keys net.0.proj and net.2."""

    def __init__(self, dim: int, inner: int = None, bias: bool = True):
        super().__init__()
        inner = inner or 4 * dim
        self.net = nn.ModuleList([_GELUProj(dim, inner, bias), nn.Identity(),
                                  nn.Linear(inner, dim, bias=bias)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class TimestepEmbedding(nn.Module):
    """diffusers TimestepEmbedding: linear_1 -> SiLU -> linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x):
        return self.linear_2(silu(self.linear_1(x)))


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int, *,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0, scale: float = 1.0,
                                  max_period: int = 10000) -> torch.Tensor:
    """[N] (possibly fractional) timesteps -> [N, embedding_dim] float32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


# --- copied from vap_tpu/models/common.py (get_3d_sincos_pos_embed) ----------
def get_3d_sincos_pos_embed(embed_dim: int, spatial_size, temporal_size: int,
                            spatial_interpolation_scale: float = 1.0,
                            temporal_interpolation_scale: float = 1.0) -> np.ndarray:
    """3D sinusoidal position table [T * H * W, embed_dim] float32 (numpy):
    t:h:w = d/4 : 3d/8 : 3d/8 with an fp64 frequency table, [sin ‖ cos] per axis.
    ``spatial_size`` is (width, height) in post-patch units."""
    if isinstance(spatial_size, int):
        spatial_size = (spatial_size, spatial_size)
    w, h = spatial_size
    dim_sp, dim_t = 3 * embed_dim // 4, embed_dim // 4

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (dim / 2.0))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(h, dtype=np.float32) / spatial_interpolation_scale
    grid_w = np.arange(w, dtype=np.float32) / spatial_interpolation_scale
    gw, gh = np.meshgrid(grid_w, grid_h)
    emb_sp = np.concatenate([_1d(dim_sp // 2, gw), _1d(dim_sp // 2, gh)], axis=1)
    grid_t = np.arange(temporal_size, dtype=np.float32) / temporal_interpolation_scale
    emb_t = _1d(dim_t, grid_t)
    pos = np.concatenate(
        [np.repeat(emb_t[:, None, :], h * w, axis=1),
         np.repeat(emb_sp[None, :, :], temporal_size, axis=0)], axis=-1)
    return pos.reshape(temporal_size * h * w, embed_dim).astype(np.float32)
