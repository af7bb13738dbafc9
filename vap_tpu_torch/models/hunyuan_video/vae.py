"""HunyuanVideo causal 3D VAE in PyTorch: the encoder and the decoder.

Port of ``vap_tpu/models/hunyuan_video/vae.py:29-192``
(``hunyuan_vae_encode``, ``hunyuan_vae_decode``): replicate-padded causal
conv3d everywhere (time pad (k-1, 0), space k//2), in the encoder's
downsamples with a stride of (2 or 1, 2, 2) after the same padding; a mid
block whose single-head attention over all latent voxels is frame-causal;
the 1x1x1 quant and post-quant convs; up blocks whose nearest upsampling
keeps the first frame out of the temporal repeat. ``prepare_latents`` is
``HunyuanVideoSpec.prepare_latents`` (``vap_tpu/training/specs.py:379-391``):
the scaled mean of the moments, channel-first, as the training cache holds
it.

Memory at 33 frames of 720x1280, where one 256-channel activation of the
decoder is 7.8e9 bf16 values, and at the encoder's 49 frames of 480x768,
where its first 128-channel activation is 2.3e9: every causal conv runs
over chunks of output frames that keep each operand under 2^30 elements
(cuDNN indexes with 32 bits), gathering each chunk's input frames (for a
strided conv the window of its first output frame starts at stride x that
frame) and padding them in time and space itself; the group norms take
their two-pass float32 statistics over chunks of groups; the mid attention
runs one latent frame of queries at a time against the keys of the frames
up to its own, the same softmax as the JAX function's masked dense one,
whose whole f32 score matrix (129,600^2 at that size) would not fit.

Tensors are channel-first [B, C, F, H, W] inside; ``hunyuan_vae_encode``
and ``hunyuan_vae_decode`` keep the JAX package's channel-last
[B, F, H, W, C]. Module attributes follow the diffusers
``AutoencoderKLHunyuanVideo`` state-dict keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..cogvideox.vae import full_float32

# elements of one conv chunk's input or output, and of one group-norm chunk
CHUNK_ELEMS = 2 ** 30
GN_CHUNK_ELEMS = 2 ** 28


@dataclasses.dataclass(frozen=True)
class HunyuanVideoVAEConfig:
    """Copied from ``vap_tpu/models/hunyuan_video/vae.py`` (``HunyuanVideoVAEConfig``)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.476986
    spatial_compression_ratio: int = 8
    temporal_compression_ratio: int = 4
    mid_block_add_attention: bool = True

    @classmethod
    def hunyuan_video(cls, **overrides) -> "HunyuanVideoVAEConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "HunyuanVideoVAEConfig":
        base = dict(latent_channels=4, block_out_channels=(8, 16),
                    layers_per_block=1, norm_num_groups=4,
                    spatial_compression_ratio=2, temporal_compression_ratio=4)
        base.update(overrides)
        return cls(**base)

    def _down_flags(self, i: int):
        """(add_spatial, add_time) for encoder block i (encoder :448-470)."""
        n = len(self.block_out_channels)
        ns = int(math.log2(self.spatial_compression_ratio))
        nt = int(math.log2(self.temporal_compression_ratio))
        is_final = i == n - 1
        if self.temporal_compression_ratio == 4:
            return i < ns, (i >= n - 1 - nt and not is_final)
        if self.temporal_compression_ratio == 8:
            return i < ns, i < nt
        raise ValueError(self.temporal_compression_ratio)

    def _up_flags(self, i: int):
        """(add_spatial, add_time) for decoder block i (decoder :572-590)."""
        n = len(self.block_out_channels)
        ns = int(math.log2(self.spatial_compression_ratio))
        nt = int(math.log2(self.temporal_compression_ratio))
        is_final = i == n - 1
        return i < ns, (i >= n - 1 - nt and not is_final)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _replicate_pad_space(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    if ph:
        x = torch.cat([x[:, :, :, :1].expand(-1, -1, -1, ph, -1), x,
                       x[:, :, :, -1:].expand(-1, -1, -1, ph, -1)], dim=3)
    if pw:
        x = torch.cat([x[..., :1].expand(-1, -1, -1, -1, pw), x,
                       x[..., -1:].expand(-1, -1, -1, -1, pw)], dim=4)
    return x


def causal_conv3d(conv: nn.Conv3d, x: torch.Tensor,
                  stride: Tuple[int, int, int] = (1, 1, 1)) -> torch.Tensor:
    """Conv3d with ``stride``, replicate-padded: causal in time (the first
    frame repeated kt - 1 times in front), symmetric in space (``causal_conv3d``,
    :81-95). Output frame j reads the padded frames [st j, st j + kt), the
    input frames st j - (kt - 1) .. st j (clamped at 0); it runs over chunks
    of output frames whose input and output stay under CHUNK_ELEMS each."""
    kt, kh, kw = conv.kernel_size
    st, sh, sw = stride
    b, c, f, h, w = x.shape
    cout = conv.out_channels
    hp, wp = h + 2 * (kh // 2), w + 2 * (kw // 2)
    fo, ho, wo = (f - 1) // st + 1, (hp - kh) // sh + 1, (wp - kw) // sw + 1
    # n output frames read (n - 1) st + kt input frames
    n = max(1, min((CHUNK_ELEMS // (b * c * hp * wp) - kt) // st + 1,
                   CHUNK_ELEMS // (b * cout * ho * wo)))
    out = torch.empty((b, cout, fo, ho, wo), dtype=x.dtype, device=x.device)
    for t0 in range(0, fo, n):
        t1 = min(t0 + n, fo)
        frames = torch.arange(st * t0 - (kt - 1), st * (t1 - 1) + 1, device=x.device).clamp_min(0)
        chunk = _replicate_pad_space(x.index_select(2, frames), kh // 2, kw // 2)
        out[:, :, t0:t1] = F.conv3d(chunk, conv.weight, conv.bias, stride=stride)
    return out


def group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm over [B, C, F, H, W] in float32, two-pass statistics and
    affine as ``group_norm3d`` (:99-106), cast to x's dtype; computed over
    chunks of groups so that no whole float32 copy is made."""
    b, c = x.shape[:2]
    g = norm.num_groups
    xg = x.reshape(b, g, c // g, -1)
    out = torch.empty_like(xg)
    w = norm.weight.float().view(g, c // g, 1)
    bias = norm.bias.float().view(g, c // g, 1)
    per = max(1, GN_CHUNK_ELEMS // (b * xg[0, 0].numel()))
    for j0 in range(0, g, per):
        j1 = min(j0 + per, g)
        xs = xg[:, j0:j1].float()
        mean = xs.mean(dim=(2, 3), keepdim=True)
        xs = xs - mean
        var = xs.square().mean(dim=(2, 3), keepdim=True)
        out[:, j0:j1] = (xs * torch.rsqrt(var + norm.eps) * w[j0:j1] + bias[j0:j1]).to(x.dtype)
    return out.reshape(x.shape)


class CausalConv3d(nn.Module):
    """HunyuanVideoCausalConv3d: key ``.conv``."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel)

    def forward(self, x, stride=(1, 1, 1)):
        return causal_conv3d(self.conv, x, stride)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = CausalConv3d(cin, cout, 3)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = CausalConv3d(cout, cout, 3)
        if cin != cout:
            self.conv_shortcut = CausalConv3d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(group_norm(self.norm1, x), inplace=True))
        h = self.conv2(F.silu(group_norm(self.norm2, h), inplace=True))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return h.add_(x)


class MidAttention(nn.Module):
    """Single-head attention over the flattened voxels with a frame-causal
    mask (``_mid_attention``, :115-128): a voxel attends to the voxels of
    its own and earlier latent frames."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q, self.to_k, self.to_v = (nn.Linear(c, c) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, f, h, w = x.shape
        hw = h * w
        n = group_norm(self.group_norm, x).permute(0, 2, 3, 4, 1).reshape(b, f * hw, c)
        q, k, v = (p(n).float() for p in (self.to_q, self.to_k, self.to_v))
        out = torch.empty_like(q)
        for t in range(f):  # the queries of frame t against the keys of frames 0..t
            s = q[:, t * hw:(t + 1) * hw] @ k[:, :(t + 1) * hw].transpose(1, 2)
            p = torch.softmax(s.mul_(c ** -0.5), dim=-1)
            del s
            out[:, t * hw:(t + 1) * hw] = p @ v[:, :(t + 1) * hw]
            del p
        out = self.to_out[0](out.to(x.dtype))
        return x + out.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)


class MidBlock(nn.Module):
    def __init__(self, c: int, cfg: HunyuanVideoVAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        self.resnets = nn.ModuleList([ResnetBlock(c, c, g), ResnetBlock(c, c, g)])
        if cfg.mid_block_add_attention:
            self.attentions = nn.ModuleList([MidAttention(c, g)])

    def forward(self, x):
        x = self.resnets[0](x)
        if hasattr(self, "attentions"):
            x = self.attentions[0](x)
        return self.resnets[1](x)


class Downsample(nn.Module):
    """HunyuanVideoDownsampleCausal3D: a strided causal conv (key ``conv``)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = CausalConv3d(c, c, 3)


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: HunyuanVideoVAEConfig, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(cin if j == 0 else cout, cout, cfg.norm_num_groups)
             for j in range(cfg.layers_per_block)])
        if downsample:
            self.downsamplers = nn.ModuleList([Downsample(cout)])


class Encoder(nn.Module):
    def __init__(self, cfg: HunyuanVideoVAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        self.conv_in = CausalConv3d(cfg.in_channels, chans[0], 3)
        self.down_blocks = nn.ModuleList(
            [DownBlock(chans[max(i - 1, 0)], cout, cfg, any(cfg._down_flags(i)))
             for i, cout in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1], cfg)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chans[-1], eps=1e-6)
        self.conv_out = CausalConv3d(chans[-1], 2 * cfg.latent_channels, 3)


def _nearest(x: torch.Tensor, dim: int, factor: int) -> torch.Tensor:
    """Repeat every element ``factor`` times along ``dim`` (one copy)."""
    if factor == 1:
        return x
    shape = list(x.shape)
    x = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], factor, *shape[dim + 1:])
    shape[dim] *= factor
    return x.reshape(shape)


class Upsample(nn.Module):
    """HunyuanVideoUpsampleCausal3D: the first frame upsampled in space
    only, the rest in time and space, then a causal conv (:131-145)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = CausalConv3d(c, c, 3)

    def forward(self, x, factor):
        ft, fh, fw = factor
        frames = [_nearest(_nearest(x[:, :, :1], 3, fh), 4, fw)]
        if x.shape[2] > 1:
            rest = _nearest(x[:, :, 1:], 2, ft)
            frames.append(_nearest(_nearest(rest, 3, fh), 4, fw))
        x = torch.cat(frames, dim=2) if len(frames) > 1 else frames[0]
        return self.conv(x)


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: HunyuanVideoVAEConfig, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(cin if j == 0 else cout, cout, cfg.norm_num_groups)
             for j in range(cfg.layers_per_block + 1)])
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample(cout)])


class Decoder(nn.Module):
    def __init__(self, cfg: HunyuanVideoVAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = CausalConv3d(cfg.latent_channels, rev[0], 3)
        self.mid_block = MidBlock(rev[0], cfg)
        self.up_blocks = nn.ModuleList(
            [UpBlock(rev[max(i - 1, 0)], cout, cfg, any(cfg._up_flags(i)))
             for i, cout in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, rev[-1], eps=1e-6)
        self.conv_out = CausalConv3d(rev[-1], cfg.out_channels, 3)


class AutoencoderKLHunyuanVideo(nn.Module):
    """The HunyuanVideo VAE: encoder, ``quant_conv``, ``post_quant_conv``,
    decoder."""

    def __init__(self, cfg: HunyuanVideoVAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv3d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv3d(cfg.latent_channels, cfg.latent_channels, 1)


@torch.no_grad()
@full_float32()
def hunyuan_vae_encode(vae: AutoencoderKLHunyuanVideo, x: torch.Tensor) -> torch.Tensor:
    """x [B, F, H, W, in_channels] in [-1, 1] -> moments [B, f, h, w,
    2 * latent] (mean, then log-variance) with f = 1 + (F - 1) / 4 and
    h, w = H / 8, W / 8 at the released ratios, in x's dtype."""
    cfg, e = vae.config, vae.encoder
    h = e.conv_in(x.permute(0, 4, 1, 2, 3).contiguous())
    for i, blk in enumerate(e.down_blocks):
        for r in blk.resnets:
            h = r(h)
        if hasattr(blk, "downsamplers"):
            add_s, add_t = cfg._down_flags(i)
            h = blk.downsamplers[0].conv(h, (2 if add_t else 1, 2 if add_s else 1,
                                             2 if add_s else 1))
    h = e.mid_block(h)
    h = e.conv_out(F.silu(group_norm(e.conv_norm_out, h), inplace=True))
    h = F.conv3d(h, vae.quant_conv.weight, vae.quant_conv.bias)
    return h.permute(0, 2, 3, 4, 1)


def prepare_latents(vae: AutoencoderKLHunyuanVideo, sample: Dict[str, Any],
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, np.ndarray]:
    """``HunyuanVideoSpec.prepare_latents``: the cache's ``latents`` [1, C,
    f, h, w] float32 of ``sample["video"]`` [F, H, W, 3] in [-1, 1] (an
    array or a tensor on any device), encoded in ``dtype`` on the VAE's
    device: the mean half of the moments times
    ``scaling_factor``, channel-first. A sample that already holds
    ``latents`` keeps them."""
    if "latents" in sample:
        return {"latents": np.asarray(sample["latents"], np.float32)}
    device = next(vae.parameters()).device
    video = torch.as_tensor(sample["video"]).to(device, torch.float32)[None].to(dtype)
    mean = hunyuan_vae_encode(vae, video)[..., :vae.config.latent_channels]
    lat = mean.float() * vae.config.scaling_factor
    return {"latents": lat.permute(0, 4, 1, 2, 3).cpu().numpy()}


@torch.no_grad()
@full_float32()
def hunyuan_vae_decode(vae: AutoencoderKLHunyuanVideo, z: torch.Tensor) -> torch.Tensor:
    """z [B, f, h, w, latent] (unscaled) -> [B, F, H, W, out_channels] with
    F = 1 + 4 (f - 1) at the released temporal ratio, in z's dtype."""
    cfg, d = vae.config, vae.decoder
    x = z.permute(0, 4, 1, 2, 3)
    x = F.conv3d(x.contiguous(), vae.post_quant_conv.weight, vae.post_quant_conv.bias)
    h = d.mid_block(d.conv_in(x))
    for i, blk in enumerate(d.up_blocks):
        for r in blk.resnets:
            h = r(h)
        if hasattr(blk, "upsamplers"):
            add_s, add_t = cfg._up_flags(i)
            h = blk.upsamplers[0](h, (2 if add_t else 1, 2 if add_s else 1, 2 if add_s else 1))
    h = d.conv_out(F.silu(group_norm(d.conv_norm_out, h), inplace=True))
    return h.permute(0, 2, 3, 4, 1)
