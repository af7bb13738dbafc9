"""Rotary position embeddings (3D, with the Video-As-Prompt reference bias).

The table functions are numpy, copied from ``vap_tpu/ops/rope.py:27-148``
(interleaved real RoPE, t:h:w = d/4 : 3d/8 : 3d/8, reference tokens at
negative temporal positions for ``ref_type="continous_negative"``, the
reference's spelling, or at the positive offsets 50, 80, 110, ... of
``"discrete_long_reference"``). CogVideoX 1.5 (``patch_size_t``) takes the
``"slice"`` grid: integer positions cut from a ``max_size`` table, the
references at ``arange(-mot_num * T, 0)`` whatever ``ref_type`` says.
``apply_rotary_emb`` and ``prepare_cogvideox_rotary_embeddings`` return and
take torch tensors.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

# temporal offsets of the references under "discrete_long_reference"
# (``start_point`` and ``gap`` of ``vap_tpu/ops/rope.py:88-89``)
DISCRETE_REF_START = 50
DISCRETE_REF_GAP = 30


# --- copied from vap_tpu/ops/rope.py:27-50 -----------------------------------
def get_1d_rotary_pos_embed(dim: int, pos: np.ndarray, theta: float = 10000.0,
                            freqs_dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Real-valued interleaved 1D RoPE table: (cos, sin), each [S, dim]."""
    if dim % 2:
        raise ValueError(f"RoPE dim must be even, got {dim}")
    pos = np.asarray(pos, dtype=np.float32)
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=freqs_dtype)[: dim // 2] / dim))
    freqs = np.outer(pos, freqs)
    cos = np.repeat(np.cos(freqs), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(freqs), 2, axis=1).astype(np.float32)
    return cos, sin


# --- copied from vap_tpu/ops/rope.py:53-67 -----------------------------------
def get_resize_crop_region_for_grid(src, tgt_width, tgt_height):
    """Aspect-preserving crop region used by CogVideoX spatial RoPE."""
    tw, th = tgt_width, tgt_height
    h, w = src
    r = h / w
    if r > (th / tw):
        resize_height = th
        resize_width = int(round(th / h * w))
    else:
        resize_width = tw
        resize_height = int(round(tw / w * h))
    crop_top = int(round((th - resize_height) / 2.0))
    crop_left = int(round((tw - resize_width) / 2.0))
    return (crop_top, crop_left), (crop_top + resize_height, crop_left + resize_width)


# --- copied from vap_tpu/ops/rope.py:77-147 -----------------------------------
@functools.lru_cache(maxsize=64)
def get_3d_rotary_pos_embed_np(
    embed_dim: int,
    crops_coords: Optional[Tuple[Tuple[int, int], Tuple[int, int]]],
    grid_size: Tuple[int, int],
    temporal_size: int,
    theta: float = 10000.0,
    mot_num: int = 0,
    ref_type: str = "continous_negative",
    grid_type: str = "linspace",
    max_size: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """3D video RoPE tables (cos, sin), each [T*H*W, embed_dim] float32.

    ``grid_type="linspace"`` spreads the grid over ``crops_coords``; with
    ``mot_num > 0`` the temporal grid holds the ``mot_num`` reference videos:
    at negative positions ending at -1 (``"continous_negative"``), or
    reference r at ``DISCRETE_REF_START + r * DISCRETE_REF_GAP + arange(T)``
    (``"discrete_long_reference"``). ``grid_type="slice"`` takes the first
    ``grid_size`` rows of integer-position tables ``max_size`` long, the
    references at ``arange(-mot_num * T, 0)``."""
    grid_size_h, grid_size_w = grid_size
    if grid_type == "linspace":
        start, stop = crops_coords
        grid_h = np.linspace(start[0], stop[0] * (grid_size_h - 1) / grid_size_h, grid_size_h,
                             dtype=np.float32)
        grid_w = np.linspace(start[1], stop[1] * (grid_size_w - 1) / grid_size_w, grid_size_w,
                             dtype=np.float32)
        grid_t = np.linspace(0, temporal_size * (temporal_size - 1) / temporal_size,
                             temporal_size, dtype=np.float32)
        if mot_num > 0:
            if ref_type == "continous_negative":
                t_range = temporal_size * (temporal_size - 1) / temporal_size - 0 + 1
                temporal_size = temporal_size * mot_num
                grid_t = np.linspace(-mot_num * t_range, -1, temporal_size, dtype=np.float32)
            elif ref_type == "discrete_long_reference":
                start_offsets = (DISCRETE_REF_START
                                 + np.arange(mot_num, dtype=np.float32) * DISCRETE_REF_GAP)
                base_range = np.arange(temporal_size, dtype=np.float32)
                grid_t = (start_offsets[:, None] + base_range[None, :]).reshape(-1).astype(
                    np.float32)
                temporal_size = temporal_size * mot_num
            else:
                raise ValueError(f"Invalid ref_type: {ref_type}")
    elif grid_type == "slice":
        max_h, max_w = max_size
        grid_h = np.arange(max_h, dtype=np.float32)
        grid_w = np.arange(max_w, dtype=np.float32)
        grid_t = np.arange(temporal_size, dtype=np.float32)
        if mot_num > 0:
            grid_t = np.arange(-mot_num * temporal_size, 0, dtype=np.float32)
            temporal_size = temporal_size * mot_num
    else:
        raise ValueError(f"Invalid grid_type: {grid_type}")

    dim_t = embed_dim // 4
    dim_h = embed_dim // 8 * 3
    dim_w = embed_dim // 8 * 3
    t_cos, t_sin = get_1d_rotary_pos_embed(dim_t, grid_t, theta=theta)
    h_cos, h_sin = get_1d_rotary_pos_embed(dim_h, grid_h, theta=theta)
    w_cos, w_sin = get_1d_rotary_pos_embed(dim_w, grid_w, theta=theta)
    if grid_type == "slice":
        t_cos, t_sin = t_cos[:temporal_size], t_sin[:temporal_size]
        h_cos, h_sin = h_cos[:grid_size_h], h_sin[:grid_size_h]
        w_cos, w_sin = w_cos[:grid_size_w], w_sin[:grid_size_w]

    def combine(ft, fh, fw):
        shape = (temporal_size, grid_size_h, grid_size_w)
        ft = np.broadcast_to(ft[:, None, None, :], shape + (ft.shape[-1],))
        fh = np.broadcast_to(fh[None, :, None, :], shape + (fh.shape[-1],))
        fw = np.broadcast_to(fw[None, None, :, :], shape + (fw.shape[-1],))
        out = np.concatenate([ft, fh, fw], axis=-1)
        return out.reshape(temporal_size * grid_size_h * grid_size_w, -1)

    return combine(t_cos, h_cos, w_cos), combine(t_sin, h_sin, w_sin)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved real RoPE. x: [..., S, D]; cos/sin: [S, D] float32.

    Pairs are (x[2i], x[2i+1]) and the rotated tensor interleaves
    (-x_imag, x_real); the math is float32 and the result is cast back."""
    x_f = x.float()
    xr = x_f.unflatten(-1, (-1, 2))
    x_rotated = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).flatten(-2)
    return (x_f * cos + x_rotated * sin).to(x.dtype)


def prepare_cogvideox_rotary_embeddings(
    height: int,
    width: int,
    num_latent_frames: int,
    *,
    attention_head_dim: int,
    patch_size: int,
    sample_width: int,
    sample_height: int,
    patch_size_t: Optional[int] = None,
    vae_scale_factor_spatial: int = 8,
    mot_num: int = 0,
    ref_type: str = "continous_negative",
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample RoPE tables as the reference pipeline builds them
    (``vap_tpu/ops/rope.py:160-210``): the cropped linspace grid, or with
    temporal patching (``patch_size_t``, CogVideoX 1.5) the ``slice`` grid
    over ceil(num_latent_frames / patch_size_t) frames, cut from tables of
    the config's sample size over the patch."""
    grid_height = height // (vae_scale_factor_spatial * patch_size)
    grid_width = width // (vae_scale_factor_spatial * patch_size)
    base_w, base_h = sample_width // patch_size, sample_height // patch_size
    if patch_size_t is None:
        crops = get_resize_crop_region_for_grid((grid_height, grid_width), base_w, base_h)
        cos, sin = get_3d_rotary_pos_embed_np(
            attention_head_dim, crops, (grid_height, grid_width), num_latent_frames,
            mot_num=mot_num, ref_type=ref_type)
    else:
        frames = (num_latent_frames + patch_size_t - 1) // patch_size_t
        cos, sin = get_3d_rotary_pos_embed_np(
            attention_head_dim, None, (grid_height, grid_width), frames, mot_num=mot_num,
            ref_type=ref_type, grid_type="slice", max_size=(base_h, base_w))
    # torch.tensor copies: the cached numpy tables are shared between calls
    return torch.tensor(cos, device=device), torch.tensor(sin, device=device)
