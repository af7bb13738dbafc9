"""CogVideoX 3D-causal VAE in PyTorch.

Port of ``vap_tpu/models/cogvideox/vae.py:82-523``: 8x spatial and 4x
temporal compression, causal 3D convolutions whose temporal state (the conv
cache) streams across frame batches, float32 group norms, and the decoder's
spatially conditioned norm. Convolutions are plain PyTorch (cuDNN on the
card), as they were XLA in JAX.

Inside, tensors are channel-first [B, C, F, H, W]; the public functions
(``vae_encode``, ``vae_decode_streamed``, ``vae_decode_wsplit``,
``vae_decode_tiled``, ``posterior_mode``) keep the JAX package's
channel-last [B, F, H, W, C]. Module attributes follow the diffusers keys
of ``AutoencoderKLCogVideoX``. The conv cache is an explicit dict keyed by
each causal conv's module path. The tiled encode is not ported (no
pipeline calls it).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Cache = Dict[str, torch.Tensor]

# temporal frame batches of the reference (autoencoder_kl_cogvideox.py:1148-1224);
# both are semantic: the group-norm statistics and the zq resize see one batch
NUM_SAMPLE_FRAMES_BATCH = 8
NUM_LATENT_FRAMES_BATCH = 2


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    """Copied from ``vap_tpu/models/cogvideox/vae.py`` (``CogVideoXVAEConfig``)."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    latent_channels: int = 16
    layers_per_block: int = 3
    norm_eps: float = 1e-6
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426
    invert_scale_latents: bool = False
    sample_height: int = 480
    sample_width: int = 720

    @property
    def temporal_compress_level(self) -> int:
        return int(np.log2(self.temporal_compression_ratio))

    @classmethod
    def tiny(cls, **overrides) -> "CogVideoXVAEConfig":
        base = dict(block_out_channels=(8, 8, 8, 8), latent_channels=4,
                    layers_per_block=1, norm_num_groups=4)
        base.update(overrides)
        return cls(**base)


def group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm in float32, cast back to x's dtype."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(),
                        norm.eps).to(x.dtype)


def _nearest_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') indexing floor(i * in / out) on one axis."""
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    if out_size % in_size == 0:
        return x.repeat_interleave(out_size // in_size, dim=axis)
    idx = torch.from_numpy((np.arange(out_size) * in_size / out_size).astype(np.int64))
    return x.index_select(axis, idx.to(x.device))


def _nearest(x: torch.Tensor, f: int, h: int, w: int) -> torch.Tensor:
    """Nearest resize of [B, C, F, H, W] to (f, h, w)."""
    return _nearest_axis(_nearest_axis(_nearest_axis(x, 2, f), 3, h), 4, w)


def _resize_zq(zq: torch.Tensor, f: int, h: int, w: int) -> torch.Tensor:
    """SpatialNorm3D's resize, with the odd-frame-count first-frame case."""
    if f > 1 and f % 2 == 1:
        return torch.cat([_nearest(zq[:, :, :1], 1, h, w), _nearest(zq[:, :, 1:], f - 1, h, w)],
                         dim=2)
    return _nearest(zq, f, h, w)


def _per_frame_conv2d(conv: nn.Conv2d, x: torch.Tensor, pad=None) -> torch.Tensor:
    """Apply a 2D conv to every frame of [B, C, F, H, W]."""
    b, c, f, h, w = x.shape
    x2 = x.transpose(1, 2).reshape(b * f, c, h, w)
    if pad is not None:
        x2 = F.pad(x2, pad)
    y = conv(x2)
    return y.reshape(b, f, *y.shape[1:]).transpose(1, 2)


class CausalConv3d(nn.Module):
    """CogVideoXCausalConv3d: temporal left pad from the cache (or the first
    frame repeated), zero spatial pad. Key: ``.conv``."""

    def __init__(self, cin: int, cout: int, kernel: int, pad: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel)
        self.time_kernel = kernel
        self.spatial_pad = pad
        self.cache_key = ""  # set to the module path by AutoencoderKLCogVideoX

    def forward(self, x: torch.Tensor, cache: Cache, new_cache: Cache) -> torch.Tensor:
        kt = self.time_kernel
        if kt > 1:
            prev = cache.get(self.cache_key)
            pad = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1) if prev is None else prev.to(x.dtype)
            x = torch.cat([pad, x], dim=2)
            # clone: a view would keep the whole padded input alive
            new_cache[self.cache_key] = x[:, :, -(kt - 1):].clone()
        p = self.spatial_pad
        return F.conv3d(x, self.conv.weight, self.conv.bias, padding=(0, p, p))


class SpatialNorm3D(nn.Module):
    """CogVideoXSpatialNorm3D: group_norm(f) * conv_y(zq) + conv_b(zq), zq
    resized to f's extent. The 1x1x1 convs run before the resize: nearest
    resize replicates pixels, so the two commute exactly."""

    def __init__(self, f_channels: int, zq_channels: int, groups: int):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, f_channels, eps=1e-6)
        self.conv_y = CausalConv3d(zq_channels, f_channels, 1, 0)
        self.conv_b = CausalConv3d(zq_channels, f_channels, 1, 0)

    def forward(self, f: torch.Tensor, zq: torch.Tensor, cache: Cache, new_cache: Cache):
        size = f.shape[2:]
        conv_y = _resize_zq(self.conv_y(zq, cache, new_cache), *size)
        conv_b = _resize_zq(self.conv_b(zq, cache, new_cache), *size)
        return group_norm(self.norm_layer, f) * conv_y + conv_b


class ResnetBlock3D(nn.Module):
    """CogVideoXResnetBlock3D without temb; spatial norms in the decoder."""

    def __init__(self, cin: int, cout: int, groups: int, eps: float,
                 zq_channels: Optional[int] = None):
        super().__init__()
        if zq_channels is None:
            self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
            self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        else:
            self.norm1 = SpatialNorm3D(cin, zq_channels, groups)
            self.norm2 = SpatialNorm3D(cout, zq_channels, groups)
        self.conv1 = CausalConv3d(cin, cout, 3, 1)
        self.conv2 = CausalConv3d(cout, cout, 3, 1)
        if cin != cout:
            self.conv_shortcut = nn.Conv3d(cin, cout, 1)

    def _norm(self, norm, h, zq, cache, new_cache):
        if isinstance(norm, SpatialNorm3D):
            return norm(h, zq, cache, new_cache)
        return group_norm(norm, h)

    def forward(self, x, zq, cache: Cache, new_cache: Cache):
        h = F.silu(self._norm(self.norm1, x, zq, cache, new_cache))
        h = self.conv1(h, cache, new_cache)
        h = F.silu(self._norm(self.norm2, h, zq, cache, new_cache))
        h = self.conv2(h, cache, new_cache)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return h + x


class Downsample3D(nn.Module):
    """CogVideoXDownsample3D: optional causal temporal average, then a
    stride-2 conv2d with (0, 1, 0, 1) padding."""

    def __init__(self, channels: int, compress_time: bool):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)
        self.compress_time = compress_time

    def forward(self, x):
        if self.compress_time:
            if x.shape[2] % 2 == 1:
                first, rest = x[:, :, :1], x[:, :, 1:]
                if rest.shape[2] > 0:
                    rest = 0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])
                x = torch.cat([first, rest], dim=2)
            else:
                x = 0.5 * (x[:, :, 0::2] + x[:, :, 1::2])
        return _per_frame_conv2d(self.conv, x, pad=(0, 1, 0, 1))


class Upsample3D(nn.Module):
    """CogVideoXUpsample3D: nearest 2x in space (and causal 2x in time), conv2d."""

    def __init__(self, channels: int, compress_time: bool):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.compress_time = compress_time

    def forward(self, x):
        f, h, w = x.shape[2:]
        if self.compress_time and f > 1 and f % 2 == 1:
            x = torch.cat([_nearest(x[:, :, :1], 1, 2 * h, 2 * w),
                           _nearest(x[:, :, 1:], 2 * (f - 1), 2 * h, 2 * w)], dim=2)
        elif self.compress_time and f > 1:
            x = _nearest(x, 2 * f, 2 * h, 2 * w)
        else:
            x = _nearest(x, f, 2 * h, 2 * w)
        return _per_frame_conv2d(self.conv, x)


class _Block(nn.Module):
    """Holder for ``resnets`` (+ ``downsamplers``/``upsamplers``), for the keys."""


class Encoder3D(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig):
        super().__init__()
        boc, g, eps = cfg.block_out_channels, cfg.norm_num_groups, cfg.norm_eps
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], 3, 1)
        self.down_blocks = nn.ModuleList()
        cin = boc[0]
        for i, cout in enumerate(boc):
            blk = _Block()
            blk.resnets = nn.ModuleList([ResnetBlock3D(cin if j == 0 else cout, cout, g, eps)
                                         for j in range(cfg.layers_per_block)])
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList(
                    [Downsample3D(cout, compress_time=i < cfg.temporal_compress_level)])
            self.down_blocks.append(blk)
            cin = cout
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock3D(boc[-1], boc[-1], g, eps)
                                                for _ in range(2)])
        self.norm_out = nn.GroupNorm(g, boc[-1], eps=1e-6)
        self.conv_out = CausalConv3d(boc[-1], 2 * cfg.latent_channels, 3, 1)

    def forward(self, x, cache: Cache, new_cache: Cache):
        h = self.conv_in(x, cache, new_cache)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h, None, cache, new_cache)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        for res in self.mid_block.resnets:
            h = res(h, None, cache, new_cache)
        h = F.silu(group_norm(self.norm_out, h))
        return self.conv_out(h, cache, new_cache)


class Decoder3D(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig):
        super().__init__()
        rev, g, eps, zq = (tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups,
                           cfg.norm_eps, cfg.latent_channels)
        self.conv_in = CausalConv3d(zq, rev[0], 3, 1)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock3D(rev[0], rev[0], g, eps, zq)
                                                for _ in range(2)])
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, cout in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList([ResnetBlock3D(cin if j == 0 else cout, cout, g, eps, zq)
                                         for j in range(cfg.layers_per_block + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList(
                    [Upsample3D(cout, compress_time=i < cfg.temporal_compress_level)])
            self.up_blocks.append(blk)
            cin = cout
        self.norm_out = SpatialNorm3D(rev[-1], zq, g)
        self.conv_out = CausalConv3d(rev[-1], cfg.out_channels, 3, 1)

    def forward(self, z, cache: Cache, new_cache: Cache):
        h = self.conv_in(z, cache, new_cache)
        for res in self.mid_block.resnets:
            h = res(h, z, cache, new_cache)
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h, z, cache, new_cache)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = F.silu(self.norm_out(h, z, cache, new_cache))
        return self.conv_out(h, cache, new_cache)


class AutoencoderKLCogVideoX(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder3D(cfg)
        self.decoder = Decoder3D(cfg)
        for name, mod in self.named_modules():
            if isinstance(mod, CausalConv3d):
                mod.cache_key = name


@contextlib.contextmanager
def full_float32():
    """Run float32 convolutions and matmuls in full float32, not TF32 (cuDNN
    takes TF32 for convolutions by default), and restore both flags after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _frame_batches(num_frames: int, frame_batch: int):
    """(start, end) of the reference's frame batches: the first one also
    takes the remainder."""
    num_batches = max(num_frames // frame_batch, 1)
    remaining = num_frames % frame_batch
    for i in range(num_batches):
        yield frame_batch * i + (0 if i == 0 else remaining), frame_batch * (i + 1) + remaining


@full_float32()
def vae_encode(vae: AutoencoderKLCogVideoX, video: torch.Tensor,
               frame_batch: int = NUM_SAMPLE_FRAMES_BATCH) -> torch.Tensor:
    """video [B, F, H, W, 3] -> latent moments [B, F', H', W', 2*Cz], over
    frame batches with the conv cache carried (``vae.py:378-399``)."""
    x = video.permute(0, 4, 1, 2, 3)
    cache: Cache = {}
    outs = []
    for start, end in _frame_batches(x.shape[2], frame_batch):
        new_cache: Cache = {}
        outs.append(vae.encoder(x[:, :, start:end], cache, new_cache))
        cache = new_cache
    return torch.cat(outs, dim=2).permute(0, 2, 3, 4, 1)


@full_float32()
def vae_decode_streamed(vae: AutoencoderKLCogVideoX, latents: torch.Tensor,
                        frame_batch: int = NUM_LATENT_FRAMES_BATCH) -> torch.Tensor:
    """latents [B, F', H', W', Cz] -> video [B, F, H, W, 3], two latent
    frames per batch with the conv cache carried (``vae.py:402-460``).

    The batch size is semantic (the zq resize and group norms see one
    batch; the checkpoint was trained at 2), and below 2 the temporal
    upsample drops frames, so ``frame_batch < 2`` raises."""
    if frame_batch < 2:
        raise ValueError("chunked decode needs frame_batch >= 2 (the temporal-upsample "
                         "cache drops frames below that)")
    z = latents.permute(0, 4, 1, 2, 3)
    cache: Cache = {}
    outs = []
    for start, end in _frame_batches(z.shape[2], frame_batch):
        new_cache: Cache = {}
        outs.append(vae.decoder(z[:, :, start:end], cache, new_cache).permute(0, 2, 3, 4, 1))
        cache = new_cache
    return torch.cat(outs, dim=1)


def blend_axis(a: torch.Tensor, b: torch.Tensor, extent: int, axis: int) -> torch.Tensor:
    """Blend the last ``extent`` entries of tile a along ``axis`` (2: rows,
    3: columns of [B, F, H, W, C]) into the first ones of tile b, linearly
    and in float32."""
    extent = min(a.shape[axis], b.shape[axis], extent)
    if extent == 0:
        return b
    shape = [1] * b.ndim
    shape[axis] = extent
    w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent).reshape(shape)
    a_tail = a.narrow(axis, a.shape[axis] - extent, extent).float()
    b_head = b.narrow(axis, 0, extent).float()
    blended = (a_tail * (1 - w) + b_head * w).to(b.dtype)
    return torch.cat([blended, b.narrow(axis, extent, b.shape[axis] - extent)], dim=axis)


def stitch_tiles(rows, blend_h: int, blend_w: int, crop_h: int, crop_w: int) -> torch.Tensor:
    """A grid of decoded tiles (rows of [B, F, h, w, 3]) as one video: each
    tile blended into its upper and left neighbours, which later tiles see
    blended (the reference's blend writes the tile in place), then cropped
    to ``crop_h`` x ``crop_w`` and concatenated."""
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j in range(len(row)):
            tile = row[j]
            if i > 0:
                tile = blend_axis(rows[i - 1][j], tile, blend_h, axis=2)
            if j > 0:
                tile = blend_axis(row[j - 1], tile, blend_w, axis=3)
            row[j] = tile
            out_row.append(tile[:, :, :crop_h, :crop_w])
        out_rows.append(torch.cat(out_row, dim=3))
    return torch.cat(out_rows, dim=2)


def vae_decode_wsplit(vae: AutoencoderKLCogVideoX, latents: torch.Tensor, n_splits: int = 2,
                      overlap_lat: int = 8,
                      frame_batch: int = NUM_LATENT_FRAMES_BATCH) -> torch.Tensor:
    """Width-split decode (``vae.py:463-506``): n equal W tiles with a
    blended overlap, each decoded by ``vae_decode_streamed``. n_splits=1 is
    the exact full-frame decode."""
    if frame_batch < 2:
        raise ValueError("vae_decode_wsplit needs frame_batch >= 2 (the temporal-upsample "
                         "cache drops frames below that)")
    if n_splits <= 1:
        return vae_decode_streamed(vae, latents, frame_batch)
    w = latents.shape[3]
    step = -(-(w - overlap_lat) // n_splits)
    span = step + overlap_lat
    starts = [min(i * step, w - span) for i in range(n_splits)]
    tiles = [vae_decode_streamed(vae, latents[:, :, :, s:s + span], frame_batch) for s in starts]
    pieces = []
    for i in range(n_splits):
        tile = tiles[i]
        if i > 0:
            tile = blend_axis(tiles[i - 1], tile, (starts[i - 1] + span - starts[i]) * 8, axis=3)
            tiles[i] = tile  # later splits blend against the blended tile
        if i < n_splits - 1:
            tile = tile[:, :, :, :(starts[i + 1] - starts[i]) * 8]
        pieces.append(tile)
    return torch.cat(pieces, dim=3)


# spatial tiles of the reference's low-memory decode (tiled_decode,
# autoencoder_kl_cogvideox.py:1255-1444), ``vae.py:625-628``
TILE_SAMPLE_MIN_H = 240
TILE_SAMPLE_MIN_W = 360
TILE_OVERLAP_H = 1 / 6
TILE_OVERLAP_W = 1 / 5


def vae_decode_tiled(vae: AutoencoderKLCogVideoX, latents: torch.Tensor) -> torch.Tensor:
    """Spatially tiled decode with overlap blending (``vae_decode_tiled``,
    ``vae.py:652-698``): latent tiles of 30 x 45 every 25 x 36, each
    decoded by ``vae_decode_streamed``, blended over 40 rows and 72 columns
    and cropped to 200 x 288 (``stitch_tiles``). latents channel-last."""
    h, w = latents.shape[2:4]
    tlh, tlw = TILE_SAMPLE_MIN_H // 8, TILE_SAMPLE_MIN_W // 8
    blend_h = int(TILE_SAMPLE_MIN_H * TILE_OVERLAP_H)
    blend_w = int(TILE_SAMPLE_MIN_W * TILE_OVERLAP_W)
    rows = [[vae_decode_streamed(vae, latents[:, :, i:i + tlh, j:j + tlw])
             for j in range(0, w, int(tlw * (1 - TILE_OVERLAP_W)))]
            for i in range(0, h, int(tlh * (1 - TILE_OVERLAP_H)))]
    return stitch_tiles(rows, blend_h, blend_w, TILE_SAMPLE_MIN_H - blend_h,
                        TILE_SAMPLE_MIN_W - blend_w)


def posterior_mode(moments: torch.Tensor) -> torch.Tensor:
    """Mean of the diagonal Gaussian in channel-last moments."""
    return moments[..., : moments.shape[-1] // 2]
