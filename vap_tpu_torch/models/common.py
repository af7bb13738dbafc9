"""Shared building blocks: fp32 norms, GELU-tanh feed-forward, timestep
embedding, the W8A8 projection linears, and block remat.

Port of ``vap_tpu/models/common.py:44-126,129+``. Linears are ``nn.Linear``
in the model dtype (bf16 on the main path) until
``quantize_transformer_linears`` replaces the attention and feed-forward
projections by ``Int8Linear`` (the JAX package's W8A8 inference path).
Norms compute in float32 and cast back, as the JAX functions do.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.int8_matmul import int8_linear_chunk, int8_mm, supported


def remat_blocks(remat) -> bool:
    """Whether ``remat`` (``scan_blocks_with_remat``, ``vap_tpu/models/common.py:273``)
    checkpoints each block: False runs the blocks plainly; True or "full"
    checkpoints each one (``run_block``). "ops" and "block_skip:N" are not
    ported and raise."""
    if isinstance(remat, str) and remat.startswith(("ops", "block_skip")):
        raise NotImplementedError(f"remat mode {remat!r} is not ported to PyTorch yet")
    if remat not in (False, None, True, "full"):
        raise ValueError(f"unknown remat mode {remat!r}; valid: False, True/'full'")
    return remat in (True, "full")


def run_block(block: nn.Module, remat: bool, *args):
    """``block(*args)``, under a non-reentrant ``torch.utils.checkpoint`` when
    ``remat``: the backward then keeps only the block's inputs and runs its
    forward again."""
    if remat:
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


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


class RMSNorm(nn.Module):
    """RMS norm over the last dim in float32 with a weight (diffusers RMSNorm)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


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


# ---------------------------------------------------------------------------
# W8A8 (``vap_tpu/models/common.py:44-126``)
# ---------------------------------------------------------------------------

# the port's names of the JAX package's INT8_LINEAR_NAMES (to_q, to_k, to_v,
# to_out, net_0, net_2): the attention and feed-forward projections
INT8_LINEAR_SUFFIXES = ("to_q", "to_k", "to_v", "to_out.0", "net.0.proj", "net.2")
ACT_SCALES = ("row", "chunk")


def quantize_linear_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """nn.Linear weight [N, K] -> (w_i8 [N, K] int8, s_w [N] f32), per
    output channel and symmetric (``quantize_linear_int8``, :79-89):
    ``s_w = max(amax / 127, 1e-12)``, ``w_i8 = round(w / s_w)``, both true
    f32 divisions and half-to-even rounding, as JAX runs them eagerly."""
    wf = weight.float()
    amax = wf.abs().amax(dim=1)
    s_w = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    return (wf / s_w[:, None]).round().to(torch.int8), s_w


def int8_linear_row(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The XLA row form ``_int8_linear`` (:58-73): activations scaled per row
    over all of K, ``s_x = max(amax / 127, 1e-8)``, ``x_i8 = round(x / s_x)``,
    an exact int8 product, then ``acc * s_x * s_w + bias`` in f32, cast to
    x's dtype. Inside the jitted model XLA turns ``amax / 127.0`` into
    ``amax * f32(1/127)``; the port computes it that way. Counts its calls
    on ``int8_linear_row.calls``."""
    n, k = w_i8.shape
    x2d = x.reshape(-1, k)
    xf = x2d.float()
    s_x = (xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)).clamp_min(1e-8)
    x_i8 = (xf / s_x).round().to(torch.int8)
    y = int8_mm(x_i8, w_i8).float() * s_x * s_w.float()
    if bias is not None:
        y = y + bias.float()
    int8_linear_row.calls += 1
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


int8_linear_row.calls = 0


class Int8Linear(nn.Module):
    """A W8A8 linear: buffers ``w_i8`` [N, K] int8 (K contiguous), ``s_w``
    [N] f32 and an optional ``bias``. ``act_scale`` picks the activation
    form, and may be switched between calls, the weights being the same:

      * "row":   ``int8_linear_row``, the JAX package's default W8A8 path;
      * "chunk": K3 (``int8_linear_chunk``) where ``supported``, else the
        row form, as JAX's ``linear()`` dispatches under
        ``VAP_INT8_PALLAS=1`` (:44-51).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 act_scale: str = "chunk", device=None, bias_dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.act_scale = act_scale
        self.register_buffer("w_i8", torch.zeros((out_features, in_features), dtype=torch.int8,
                                                 device=device))
        self.register_buffer("s_w", torch.ones(out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(out_features, dtype=bias_dtype, device=device)
                             if bias else None)

    @property
    def act_scale(self) -> str:
        return self._act_scale

    @act_scale.setter
    def act_scale(self, value: str) -> None:
        if value not in ACT_SCALES:
            raise ValueError(f"unknown act_scale {value!r}; valid: {ACT_SCALES}")
        self._act_scale = value

    @classmethod
    def from_linear(cls, linear: nn.Linear, act_scale: str = "chunk",
                    device: Optional[torch.device] = None) -> "Int8Linear":
        """The W8A8 form of ``linear``, its buffers where its weight is; the
        quantisation runs on ``device`` when given (the card, for a weight
        kept in host memory)."""
        w = linear.weight
        out = cls(linear.in_features, linear.out_features, linear.bias is not None, act_scale,
                  device=w.device, bias_dtype=w.dtype)
        with torch.no_grad():
            w_i8, s_w = quantize_linear_int8(w if device is None else w.to(device))
            out.w_i8.copy_(w_i8)
            out.s_w.copy_(s_w)
            if linear.bias is not None:
                out.bias.copy_(linear.bias)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"Int8Linear: tensors on {x.device} are not supported")
        if self._act_scale == "chunk" and supported(self.w_i8, x):
            return int8_linear_chunk(x, self.w_i8, self.s_w, self.bias)
        return int8_linear_row(x, self.w_i8, self.s_w, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, act_scale={self._act_scale!r}")


def is_int8_projection(name: str) -> bool:
    """True for the qualified module names the W8A8 path covers."""
    return any(name == s or name.endswith("." + s) for s in INT8_LINEAR_SUFFIXES)


def quantize_transformer_linears(module: nn.Module, act_scale: str = "chunk",
                                 device: Optional[torch.device] = None) -> List[str]:
    """Replace, in place, every ``nn.Linear`` named like one of the JAX
    package's ``INT8_LINEAR_NAMES`` (``map_transformer_linears``, :107-126)
    by an ``Int8Linear``; returns their qualified names. In place, one
    linear at a time, so the peak stays at the bf16 model's: each bf16
    weight is freed as its int8 copy is made. With ``device`` each weight
    is quantised there and its int8 copy returns to where the weight was
    (a model kept in host memory under offload, quantised on the card).
    Inference only."""
    names = [n for n, m in module.named_modules()
             if isinstance(m, nn.Linear) and is_int8_projection(n)]
    for name in names:
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        setattr(parent, child, Int8Linear.from_linear(getattr(parent, child), act_scale, device))
    return names


def set_int8_act_scale(module: nn.Module, act_scale: str) -> int:
    """Switch every ``Int8Linear`` of ``module`` to ``act_scale``; returns
    how many there are."""
    layers = [m for m in module.modules() if isinstance(m, Int8Linear)]
    for m in layers:
        m.act_scale = act_scale
    return len(layers)


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
