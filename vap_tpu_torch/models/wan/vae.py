"""Wan2.1 3D-causal VAE in PyTorch.

Port of ``vap_tpu/models/wan/vae.py:78-353`` (``AutoencoderKLWan``): causal
time convolutions with a two-frame feature cache streamed across temporal
chunks, the "Rep" sentinel that marks an upsampler whose first chunk has
passed, WanRMS_norm, a single-head spatial attention in the mid blocks, and
z_dim 16 latents with per-channel mean/std normalisation. Encode consumes
chunks of [1, 4, 4, ...] frames; the streamed decode emits one latent frame
per step. Convolutions and the attention block are plain PyTorch (cuDNN
and cuBLAS on the card), as they were XLA in JAX; the public functions run
them in full float32 precision (no TF32) and restore the caller's settings.

Inside, tensors are channel-first [B, C, F, H, W]; the public functions
(``wan_vae_encode``, ``wan_vae_decode_streamed``, ``wan_vae_decode_tiled``,
``normalize_latents``, ``denormalize_latents``) keep the JAX package's
channel-last [B, F, H, W, C]. Module attributes follow the diffusers keys of
``AutoencoderKLWan``. The feature cache is a flat dict keyed by each causal
conv's module path. The tiled encode is not ported (no pipeline calls it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..cogvideox.vae import full_float32, stitch_tiles

CACHE_T = 2
REP = "Rep"  # sentinel: the upsampler's first chunk is done, zero-pad mode
Cache = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    """Copied from ``vap_tpu/models/wan/vae.py`` (``WanVAEConfig``)."""

    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    latents_mean: Tuple[float, ...] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
    )
    latents_std: Tuple[float, ...] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
    )

    @property
    def temperal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))

    @classmethod
    def tiny(cls, **overrides) -> "WanVAEConfig":
        base = dict(base_dim=8, z_dim=4, dim_mult=(1, 1, 1, 1), num_res_blocks=1,
                    latents_mean=tuple([0.0] * 4), latents_std=tuple([1.0] * 4))
        base.update(overrides)
        return cls(**base)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _frames(x: torch.Tensor) -> int:
    return x.shape[2]


def update_cache(old, x: torch.Tensor) -> torch.Tensor:
    """The last CACHE_T input frames; a shorter chunk borrows the last frame
    of the previous cache (autoencoder_kl_wan.py:252-256)."""
    cache = x[:, :, -CACHE_T:]
    if _frames(cache) < CACHE_T and old is not None and old is not REP:
        cache = torch.cat([old[:, :, -1:].to(cache.dtype), cache], dim=2)
    return cache


class CausalConv3d(nn.Conv3d):
    """WanCausalConv3d: a left temporal pad of 2 * pad_t, less the cached
    frames prepended from the cache; symmetric spatial padding."""

    def __init__(self, cin: int, cout: int, kernel, pad_t: int = 0, pad_s: int = 0,
                 stride=1):
        super().__init__(cin, cout, kernel, stride=stride)
        self.pad_t, self.pad_s = pad_t, pad_s

    def forward(self, x: torch.Tensor, cache=None) -> torch.Tensor:
        left = 2 * self.pad_t
        if cache is not None and cache is not REP and left > 0:
            x = torch.cat([cache.to(x.dtype), x], dim=2)
            left -= _frames(cache)
        s = self.pad_s
        x = F.pad(x, (s, s, s, s, left, 0))
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride)


class RMSNormVideo(nn.Module):
    """WanRMS_norm: x / ||x||_channels * sqrt(C) * gamma, in float32."""

    def __init__(self, dim: int, images: bool = False):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, *((1, 1) if images else (1, 1, 1))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf.square().sum(dim=1, keepdim=True).sqrt()
        y = xf / norm.clamp_min(1e-12) * (x.shape[1] ** 0.5)
        return (y * self.gamma.float().reshape(1, -1, *[1] * (x.ndim - 2))).to(x.dtype)


class ResidualBlock(nn.Module):
    """WanResidualBlock (autoencoder_kl_wan.py:207-276)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = RMSNormVideo(cin)
        self.conv1 = CausalConv3d(cin, cout, 3, pad_t=1, pad_s=1)
        self.norm2 = RMSNormVideo(cout)
        self.conv2 = CausalConv3d(cout, cout, 3, pad_t=1, pad_s=1)
        if cin != cout:
            self.conv_shortcut = CausalConv3d(cin, cout, 1)

    def forward(self, x, name: str, cache: Cache, new_cache: Cache):
        h = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        y = F.silu(self.norm1(x))
        new_cache[f"{name}.conv1"] = update_cache(cache.get(f"{name}.conv1"), y)
        y = self.conv1(y, cache.get(f"{name}.conv1"))
        y = F.silu(self.norm2(y))
        new_cache[f"{name}.conv2"] = update_cache(cache.get(f"{name}.conv2"), y)
        y = self.conv2(y, cache.get(f"{name}.conv2"))
        return y + h


class AttentionBlock(nn.Module):
    """WanAttentionBlock: per-frame single-head spatial attention (:278-325)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = RMSNormVideo(dim, images=True)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b * f, h * w, c)
        qkv = F.linear(y, self.to_qkv.weight[:, :, 0, 0].to(y.dtype), self.to_qkv.bias.to(y.dtype))
        q, k, v = qkv.chunk(3, dim=-1)
        s = (q.float() @ k.float().transpose(1, 2)) * (c ** -0.5)
        o = torch.softmax(s, dim=-1).to(v.dtype) @ v
        o = F.linear(o, self.proj.weight[:, :, 0, 0].to(o.dtype), self.proj.bias.to(o.dtype))
        return x + o.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)


class Resample(nn.Module):
    """WanResample (autoencoder_kl_wan.py:123-205): 2x spatial up or down,
    with a causal time conv in the 3d modes."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        self.mode = mode
        if mode.startswith("up"):
            conv = nn.Conv2d(dim, dim // 2, 3, padding=1)
        else:
            conv = nn.Conv2d(dim, dim, 3, stride=2)
        self.resample = nn.Sequential(nn.Identity(), conv)
        if mode == "upsample3d":
            self.time_conv = CausalConv3d(dim, 2 * dim, (3, 1, 1), pad_t=1)
        elif mode == "downsample3d":
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1))

    def _per_frame(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, h, w = x.shape
        y = x.transpose(1, 2).reshape(b * f, c, h, w)
        conv = self.resample[1]
        if self.mode.startswith("down"):
            y = F.pad(y, (0, 1, 0, 1))
        y = F.conv2d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype), conv.stride, conv.padding)
        return y.reshape(b, f, *y.shape[1:]).transpose(1, 2)

    def forward(self, x, name: str, cache: Cache, new_cache: Cache):
        key = f"{name}.time_conv"
        if self.mode == "upsample3d":
            old = cache.get(key)
            if old is None:
                new_cache[key] = REP  # the first chunk takes no time conv
            else:
                b, c, f, h, w = x.shape
                cur = x[:, :, -CACHE_T:]
                if _frames(cur) < 2:
                    head = torch.zeros_like(cur) if old is REP else old[:, :, -1:].to(cur.dtype)
                    cur = torch.cat([head, cur], dim=2)
                y = self.time_conv(x, None if old is REP else old)
                new_cache[key] = cur
                # [B, 2C, F, H, W]: the two C-groups become interleaved frames
                x = y.reshape(b, 2, c, f, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * f, h, w)
        if self.mode.startswith("up"):
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)  # nearest 2x
        x = self._per_frame(x)
        if self.mode == "downsample3d":
            old = cache.get(key)
            if old is None:
                new_cache[key] = x
            else:
                new_cache[key] = x[:, :, -1:]
                x = self.time_conv(torch.cat([old[:, :, -1:].to(x.dtype), x], dim=2), REP)
        return x


class MidBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResidualBlock(dim, dim), ResidualBlock(dim, dim)])
        self.attentions = nn.ModuleList([AttentionBlock(dim)])

    def forward(self, x, name: str, cache: Cache, new_cache: Cache):
        x = self.resnets[0](x, f"{name}.resnets.0", cache, new_cache)
        x = self.attentions[0](x)
        return self.resnets[1](x, f"{name}.resnets.1", cache, new_cache)


def _head_conv(conv: CausalConv3d, x, name: str, cache: Cache, new_cache: Cache):
    new_cache[name] = update_cache(cache.get(name), x)
    return conv(x, cache.get(name))


class Encoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims = [cfg.base_dim * u for u in [1] + list(cfg.dim_mult)]
        n_stages = len(cfg.dim_mult)
        self.conv_in = CausalConv3d(3, dims[0], 3, pad_t=1, pad_s=1)
        blocks = []
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            for j in range(cfg.num_res_blocks):
                blocks.append(ResidualBlock(cin if j == 0 else cout, cout))
            if i != n_stages - 1:
                blocks.append(Resample(cout, "downsample3d" if cfg.temperal_downsample[i]
                                       else "downsample2d"))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(dims[-1])
        self.norm_out = RMSNormVideo(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], 2 * cfg.z_dim, 3, pad_t=1, pad_s=1)

    def forward(self, x, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new_cache: Cache = {}
        x = _head_conv(self.conv_in, x, "conv_in", cache, new_cache)
        for i, block in enumerate(self.down_blocks):
            x = block(x, f"down_blocks.{i}", cache, new_cache)
        x = self.mid_block(x, "mid_block", cache, new_cache)
        x = F.silu(self.norm_out(x))
        return _head_conv(self.conv_out, x, "conv_out", cache, new_cache), new_cache


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, num_res_blocks: int, mode: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList([ResidualBlock(cin if j == 0 else cout, cout)
                                      for j in range(num_res_blocks + 1)])
        if mode is not None:
            self.upsamplers = nn.ModuleList([Resample(cout, mode)])

    def forward(self, x, name: str, cache: Cache, new_cache: Cache):
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, f"{name}.resnets.{j}", cache, new_cache)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x, f"{name}.upsamplers.0", cache, new_cache)
        return x


class Decoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims = [cfg.base_dim * u for u in [cfg.dim_mult[-1]] + list(cfg.dim_mult)[::-1]]
        n_stages = len(cfg.dim_mult)
        up = cfg.temperal_upsample
        self.conv_in = CausalConv3d(cfg.z_dim, dims[0], 3, pad_t=1, pad_s=1)
        self.mid_block = MidBlock(dims[0])
        blocks = []
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            if i > 0:
                cin = cin // 2  # the previous stage's upsampler halved the channels
            mode = None if i == n_stages - 1 else ("upsample3d" if up[i] else "upsample2d")
            blocks.append(_UpBlock(cin, cout, cfg.num_res_blocks, mode))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = RMSNormVideo(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], 3, 3, pad_t=1, pad_s=1)

    def forward(self, z, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new_cache: Cache = {}
        x = _head_conv(self.conv_in, z, "conv_in", cache, new_cache)
        x = self.mid_block(x, "mid_block", cache, new_cache)
        for i, block in enumerate(self.up_blocks):
            x = block(x, f"up_blocks.{i}", cache, new_cache)
        x = F.silu(self.norm_out(x))
        return _head_conv(self.conv_out, x, "conv_out", cache, new_cache), new_cache


class AutoencoderKLWan(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder3d(cfg)
        self.decoder = Decoder3d(cfg)
        self.quant_conv = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, 1)
        self.post_quant_conv = CausalConv3d(cfg.z_dim, cfg.z_dim, 1)


# ---------------------------------------------------------------------------
# public streaming API (channel-last at the boundary)
# ---------------------------------------------------------------------------

@full_float32()
def wan_vae_encode(vae: AutoencoderKLWan, video: torch.Tensor) -> torch.Tensor:
    """video [B, F, H, W, 3] with F = 1 + 4k -> latent moments
    [B, 1 + k, H/8, W/8, 2 * z_dim], in chunks of [1, 4, 4, ...] frames."""
    x = video.permute(0, 4, 1, 2, 3)
    cache: Cache = {}
    outs = []
    for i in range(1 + (x.shape[2] - 1) // 4):
        chunk = x[:, :, :1] if i == 0 else x[:, :, 1 + 4 * (i - 1): 1 + 4 * i]
        out, cache = vae.encoder(chunk, cache)
        outs.append(out)
    moments = vae.quant_conv(torch.cat(outs, dim=2))
    return moments.permute(0, 2, 3, 4, 1)


@full_float32()
def wan_vae_decode_streamed(vae: AutoencoderKLWan, latents: torch.Tensor) -> torch.Tensor:
    """latents [B, F', H', W', z_dim] -> video [B, 1 + 4(F' - 1), H, W, 3],
    clamped to [-1, 1]; one latent frame per decoder step, the feature cache
    carried between steps."""
    z = vae.post_quant_conv(latents.permute(0, 4, 1, 2, 3))
    cache: Cache = {}
    outs = []
    for i in range(z.shape[2]):
        out, cache = vae.decoder(z[:, :, i:i + 1], cache)
        outs.append(out)
    return torch.cat(outs, dim=2).clamp(-1.0, 1.0).permute(0, 2, 3, 4, 1)


def normalize_latents(cfg: WanVAEConfig, z: torch.Tensor) -> torch.Tensor:
    """(z - mean) / std per channel, channel-last."""
    mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
    std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
    return (z - mean) / std


def denormalize_latents(cfg: WanVAEConfig, z: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(cfg.latents_mean, dtype=z.dtype, device=z.device)
    std = torch.tensor(cfg.latents_std, dtype=z.dtype, device=z.device)
    return z * std + mean


# ---------------------------------------------------------------------------
# spatial tiling (AutoencoderKLWan.tiled_decode, autoencoder_kl_wan.py:940-1063;
# ``vae.py:359-417``): stride-based overlapping tiles, linearly blended,
# cropped to the stride and concatenated
# ---------------------------------------------------------------------------

TILE_SAMPLE_MIN = 256
TILE_SAMPLE_STRIDE = 192


def wan_vae_decode_tiled(vae: AutoencoderKLWan, latents: torch.Tensor) -> torch.Tensor:
    """Spatially tiled decode of denormalised latents [B, F', H', W', z]:
    latent tiles of 32 x 32 every 24, each decoded by
    ``wan_vae_decode_streamed``, blended over 64 pixels and cropped to the
    stride (``stitch_tiles``)."""
    h, w = latents.shape[2:4]
    ratio = 8
    tlm, tls = TILE_SAMPLE_MIN // ratio, TILE_SAMPLE_STRIDE // ratio
    blend = TILE_SAMPLE_MIN - TILE_SAMPLE_STRIDE
    rows = [[wan_vae_decode_streamed(vae, latents[:, :, i:i + tlm, j:j + tlm])
             for j in range(0, w, tls)] for i in range(0, h, tls)]
    video = stitch_tiles(rows, blend, blend, TILE_SAMPLE_STRIDE, TILE_SAMPLE_STRIDE)
    return video[:, :, :h * ratio, :w * ratio]
