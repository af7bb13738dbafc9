"""The port's attention kernels and their plain PyTorch versions.

K1 and K4 ``flash_attention_forward``: non-causal softmax(Q K^T * scale) V
with the natural-log lse, bf16. Head_dim < 128 launches K1, the forward of
``vap_tpu/ops/flash_attention.py`` ``flash_attention`` at D < 128
(``_flash_attention_forward_t``); head_dim 128 launches K4, its row-layout
forward at D >= 128 (``_flash_attention_forward``). Both are one CUDA
kernel templated on head_dim, ``csrc/flash_fwd.cu``, with one entry point
each.

K2 ``flash_attention_int8_forward``: the SageAttention-style forward of
``flash_attention_int8`` (``_flash_attention_forward_t_i8``): K smoothing,
symmetric int8 Q and K with one scale per (b, h), int8 Q K^T with int32
accumulation, scores in the log2 domain, bf16 P V. CUDA source:
``csrc/sage_fwd.cu``; the quantisation pre-pass is plain PyTorch here, as it
was plain XLA outside the Pallas kernel.

Layout: q [B, H, Sq, D], k and v [B, H, Skv, D]; out [B, H, Sq, D] in the
input dtype, lse [B, H, Sq] float32.

Each wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; on any other device, or on inputs the kernel does not take, it
raises. Each kernel counts its launches on its wrapper:
``flash_attention_forward.launches`` (K1),
``flash_attention_forward.launches_d128`` (K4) and
``flash_attention_int8_forward.launches`` (K2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

LOG2_E = 1.4426950408889634
LN_2 = 0.6931471805599453
# masked-score value of the TPU kernels (finite, so no inf - inf arises)
NEG_INF = -1e30
# keys per tile of the plain versions: bounds their score buffer to
# [B, H, Sq, PLAIN_BLOCK_K], so they also run at the main-path length
PLAIN_BLOCK_K = 512
# grid.y of the CUDA launch indexes B*H
_MAX_BH = 65535


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be [B, H, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


def _kernel_inputs(name: str, tensors: dict, dtypes: dict, bh: int, sq: int) -> None:
    """Raise unless every tensor is a contiguous, 16-byte-aligned CUDA tensor
    of the expected dtype on one device, with a grid the kernel can launch."""
    device = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtypes[arg]:
            raise ValueError(f"{name}: {arg} must be {dtypes[arg]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if sq < 1 or bh < 1 or bh > _MAX_BH:
        raise ValueError(f"{name}: needs Sq >= 1 and 1 <= B*H <= {_MAX_BH}, "
                         f"got Sq={sq}, B*H={bh}")


def _device_kind(name: str, q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {q.device} are not supported")
    return q.device.type


# ---------------------------------------------------------------------------
# plain versions: the same tile recurrence as the kernels, in PyTorch
# ---------------------------------------------------------------------------

def softmax_tile_update(m, l, acc, s, v_tile):
    """One kv tile of the running-max online softmax, as the kernels run it.

    m, l: [..., Sq, 1] f32 running max (log2 domain) and denominator;
    acc: [..., Sq, D] f32 numerator; s: [..., Sq, n] f32 log2-domain scores
    (masked keys at NEG_INF); v_tile: [..., n, D]. P is rounded to v's dtype
    before both the P V product and the row sum, as in the kernels.
    """
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(s - m_new).to(v_tile.dtype).float()
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + p @ v_tile.float()
    return m_new, l, acc


def softmax_finalize(m, l, acc, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalise with the TPU kernels' ``l == 0 -> 1`` guard; natural-log lse."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe).to(dtype)
    lse = (LN_2 * (m + torch.log2(l_safe))).squeeze(-1)
    return out, lse


def _online_softmax_plain(scores, v: torch.Tensor, sq: int):
    """Tile loop over keys; ``scores(n0, n1)`` gives log2-domain f32 scores."""
    lead, d, skv = v.shape[:-2], v.shape[-1], v.shape[-2]
    m = torch.full((*lead, sq, 1), NEG_INF, dtype=torch.float32, device=v.device)
    l = torch.zeros((*lead, sq, 1), dtype=torch.float32, device=v.device)
    acc = torch.zeros((*lead, sq, d), dtype=torch.float32, device=v.device)
    for n0 in range(0, skv, PLAIN_BLOCK_K):
        n1 = min(n0 + PLAIN_BLOCK_K, skv)
        m, l, acc = softmax_tile_update(m, l, acc, scores(n0, n1), v[..., n0:n1, :])
    return softmax_finalize(m, l, acc, v.dtype)


def flash_attention_forward_plain(q, k, v, scale: Optional[float] = None):
    """Plain PyTorch version of K1: returns (out, lse)."""
    _shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float()
    scale_log2 = scale * LOG2_E

    def scores(n0, n1):
        return (qf @ k[..., n0:n1, :].float().transpose(-1, -2)) * scale_log2

    return _online_softmax_plain(scores, v, q.shape[2])


def sage_quantize(q, k, scale: float):
    """The int8 pre-pass of ``_flash_attention_forward_t_i8`` (:843-852).

    K smoothing (minus the token mean of K per (b, h, d)), then symmetric
    int8 with one scale per (b, h) for Q and for the smoothed K, rounded half
    to even. Returns q_i8, k_i8 (int8, input shapes) and
    sqk = s_q * s_k * scale * log2(e) [B, H] f32.

    One float32 copy of each input is worked in place, and the abs-max is
    taken as max(max, -min), so the pass holds one f32 copy at a time (at
    Wan's joint shape a copy is 1.7 GB).
    """
    def absmax(x):
        return torch.maximum(x.amax(dim=(2, 3), keepdim=True), -x.amin(dim=(2, 3), keepdim=True))

    s_q = (absmax(q).float() / 127.0).clamp_min(1e-8)
    q_i8 = q.to(torch.float32, copy=True).div_(s_q).round_().to(torch.int8)
    ks = k.to(torch.float32, copy=True)
    ks.sub_(ks.mean(dim=2, keepdim=True))
    s_k = (absmax(ks) / 127.0).clamp_min(1e-8)
    k_i8 = ks.div_(s_k).round_().to(torch.int8)
    sqk = (s_q * s_k * scale * LOG2_E).reshape(q.shape[:2])
    return q_i8, k_i8, sqk


def _sage_plain(q_i8, k_i8, sqk, v):
    qf = q_i8.float()
    s = sqk[..., None, None]

    def scores(n0, n1):
        # int8 products summed in f32 are exact: |sum| <= D * 127^2 < 2^24
        return (qf @ k_i8[..., n0:n1, :].float().transpose(-1, -2)) * s

    return _online_softmax_plain(scores, v, q_i8.shape[2])


def _sage_checks(q, k, v):
    _shapes(q, k, v)
    if q.shape[-1] % 32:
        raise ValueError(f"int8 path needs head_dim % 32 == 0, got {q.shape[-1]}")
    if k.shape[2] < 1:
        raise ValueError("int8 path needs at least one key (K smoothing takes its mean)")


def flash_attention_int8_forward_plain(q, k, v, scale: Optional[float] = None):
    """Plain PyTorch version of K2: returns (out, lse)."""
    _sage_checks(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _sage_plain(*sage_quantize(q, k, scale), v)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_attention_forward(q, k, v, scale: Optional[float] = None):
    """K1 and K4: (out, lse). CUDA tensors launch ``vap_flash_fwd`` (K1,
    head_dim a multiple of 16 below 128) or ``vap_flash_fwd_d128`` (K4,
    head_dim 128): bf16, contiguous. CPU tensors take
    ``flash_attention_forward_plain``."""
    _shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind("flash_attention_forward", q) == "cpu":
        return flash_attention_forward_plain(q, k, v, scale)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d % 16 or d > 128:
        raise ValueError(f"flash kernel takes head_dim in 16..128 step 16, got {d}")
    bf16 = torch.bfloat16
    _kernel_inputs("flash_attention_forward", {"q": q, "k": k, "v": v},
                   {"q": bf16, "k": bf16, "v": bf16}, b * h, sq)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if d == 128:
            err = lib.vap_flash_fwd_d128(*ptrs, b * h, sq, skv, scale * LOG2_E, stream)
            _build.check(err, "vap_flash_fwd_d128")
            flash_attention_forward.launches_d128 += 1
        else:
            err = lib.vap_flash_fwd(*ptrs, b * h, sq, skv, d, scale * LOG2_E, stream)
            _build.check(err, "vap_flash_fwd")
            flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0
flash_attention_forward.launches_d128 = 0


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Fused full attention (K1 or K4 by head_dim), output only."""
    return flash_attention_forward(q, k, v, scale)[0]


def flash_attention_int8_forward(q, k, v, scale: Optional[float] = None):
    """K2: (out, lse). The int8 pre-pass runs in PyTorch; CUDA tensors then
    launch ``vap_sage_fwd`` (bf16 v, head_dim 32, 64, 96 or 128, contiguous), CPU
    tensors take the plain version."""
    _sage_checks(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kind = _device_kind("flash_attention_int8_forward", q)
    q_i8, k_i8, sqk = sage_quantize(q, k, scale)
    if kind == "cpu":
        return _sage_plain(q_i8, k_i8, sqk, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d > 128:
        raise ValueError(f"sage kernel takes head_dim 32, 64, 96 or 128, got {d}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_int8_forward: q must be bfloat16, got {q.dtype}")
    i8 = torch.int8
    _kernel_inputs("flash_attention_int8_forward",
                   {"q_i8": q_i8, "k_i8": k_i8, "sqk": sqk, "v": v},
                   {"q_i8": i8, "k_i8": i8, "sqk": torch.float32, "v": torch.bfloat16},
                   b * h, sq)
    out = torch.empty((b, h, sq, d), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _build.library("sage_fwd")
    with torch.cuda.device(q.device):
        err = lib.vap_sage_fwd(q_i8.data_ptr(), k_i8.data_ptr(), sqk.data_ptr(), v.data_ptr(),
                               out.data_ptr(), lse.data_ptr(), b * h, sq, skv, d,
                               torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vap_sage_fwd")
    flash_attention_int8_forward.launches += 1
    return out, lse


flash_attention_int8_forward.launches = 0


def flash_attention_int8(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """SageAttention-style int8-QK attention (K2), output only."""
    return flash_attention_int8_forward(q, k, v, scale)[0]
