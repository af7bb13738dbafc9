"""The W8A8 linear kernel (K3) and its plain PyTorch version.

Port of ``vap_tpu/ops/int8_matmul.py``. K3 ``int8_linear_chunk`` computes
what ``_w8a8_kernel`` (``:43-62``) computes: per (row, K-chunk) of
``C = _pick(K, BLOCK_K)`` columns, an abs-max symmetric int8 quantisation of
the activations (``amax = max(max|x|, 1e-8)``, ``x_i8 = rint(x * (127 /
amax))``, ``s_x = amax * (1 / 127)``), an int8 x int8 -> int32 product per
chunk, each chunk's int32 partial turned into f32 times its ``s_x`` and
added to an f32 sum in chunk order, then ``y = acc * s_w + bias`` in f32,
cast to x's dtype. The weight is ``w_i8 [N, K]`` int8 (nn.Linear's layout,
K contiguous: the K-major B operand of the int8 ``wgmma`` as it lies) with
one f32 scale per output channel ``s_w [N]``.

CUDA source: ``csrc/w8a8.cu`` (a quantise pass, then the int8 ``wgmma``
GEMM of ``csrc/gemm_sm90.cuh``, TMA-fed and persistent, that folds its
int32 accumulator into f32 at each chunk boundary; bit-equal to the plain
version). CUDA tensors launch it, CPU tensors take
``int8_linear_chunk_plain``, any other device raises. The kernel counts its
launches on ``int8_linear_chunk.launches``.

``supported`` is the JAX package's shape rule (``:101-106``): a 2-D weight
whose K and N tile to at least 128. ``int8_mm`` is the exact int8 product
the plain versions and the row form (``models/common.py``) share: a float64
product on the CPU (exact: |sum| <= 127^2 * K < 2^53) and ``torch._int_mm``
on the card, where the JAX package left the product to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# the JAX kernel's preferred tiles: BLOCK_K is the quantisation chunk,
# BLOCK_N only enters ``supported``
BLOCK_N = 1024
BLOCK_K = 1536
# rows and columns of one output tile of the CUDA GEMM (csrc/w8a8.cu on
# csrc/gemm_sm90.cuh), which ``linear_bench --impl diag`` prints
TILE_M, TILE_N = 128, 192


# --- copied from vap_tpu/ops/int8_matmul.py:65-69 --------------------------
def _pick(total: int, preferred: int) -> int:
    for b in (preferred, 1024, 512, 256, 128):
        if b <= preferred and total % b == 0:
            return b
    return 0


def supported(w_i8: torch.Tensor, x: torch.Tensor) -> bool:
    """Shapes the kernel handles (``int8_matmul.py:101-106`` with the weight
    as [N, K]): a 2-D int8 weight whose K and N are tileable."""
    return (w_i8.ndim == 2 and x.shape[-1] == w_i8.shape[1]
            and _pick(w_i8.shape[1], BLOCK_K) >= 128
            and _pick(w_i8.shape[0], BLOCK_N) >= 128)


def int8_mm(a_i8: torch.Tensor, b_i8: torch.Tensor) -> torch.Tensor:
    """Exact a_i8 [M, K] @ b_i8[N, K]^T as int32 [M, N]. CPU: a float64
    product (exact integers); CUDA: ``torch._int_mm``, with zero rows and
    columns padded to its shape rule (M > 16, K and N multiples of 8)."""
    m, k = a_i8.shape
    n = b_i8.shape[0]
    if a_i8.device.type == "cpu":
        return (a_i8.double() @ b_i8.double().T).to(torch.int32)
    if a_i8.device.type != "cuda":
        raise ValueError(f"int8_mm: tensors on {a_i8.device} are not supported")
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a_i8 = torch.nn.functional.pad(a_i8, (0, pk, 0, pm))
    if pk or pn:
        b_i8 = torch.nn.functional.pad(b_i8, (0, pk, 0, pn))
    out = torch._int_mm(a_i8.contiguous(), b_i8.contiguous().T)
    return out[:m, :n] if (pm or pn) else out


def quantize_chunks(x2d: torch.Tensor, chunk: int):
    """K3's quantise step on x [M, K]: (x_i8 [M, K] int8, s_x [M, K/chunk]
    f32). The reciprocal 127/amax is a true division, then multiplied, as
    in ``_w8a8_kernel`` (:51-52)."""
    m, k = x2d.shape
    xf = x2d.float().reshape(m, k // chunk, chunk)
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    x_i8 = (xf * (amax.new_tensor(127.0) / amax)).round().to(torch.int8).reshape(m, k)
    return x_i8, (amax * (1.0 / 127.0)).squeeze(-1)


def int8_linear_chunk_plain(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor,
                            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K3: x [..., K] -> [..., N] in x's dtype."""
    n, k = w_i8.shape
    chunk = _pick(k, BLOCK_K)
    if not chunk:
        raise ValueError(f"W8A8 chunk form needs K tileable to >= 128, got K={k}")
    x2d = x.reshape(-1, k)
    x_i8, s_x = quantize_chunks(x2d, chunk)
    acc = torch.zeros((x2d.shape[0], n), dtype=torch.float32, device=x.device)
    for c in range(k // chunk):
        cols = slice(c * chunk, (c + 1) * chunk)
        part = int8_mm(x_i8[:, cols], w_i8[:, cols]).float()
        acc = acc + part * s_x[:, c:c + 1]
    y = acc * s_w.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


def _check_kernel_inputs(x2d, w_i8, s_w, bias) -> None:
    tensors = {"x": (x2d, torch.bfloat16), "w_i8": (w_i8, torch.int8),
               "s_w": (s_w, torch.float32)}
    if bias is not None:
        tensors["bias"] = (bias, torch.float32)
    for name, (t, dtype) in tensors.items():
        if t.device != x2d.device:
            raise ValueError(f"int8_linear_chunk: {name} is on {t.device}, expected {x2d.device}")
        if t.dtype != dtype:
            raise ValueError(f"int8_linear_chunk: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_linear_chunk: {name} must be contiguous and 16-byte aligned")


def int8_linear_chunk(x: torch.Tensor, w_i8: torch.Tensor, s_w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: x [..., K] -> [..., N]. CUDA tensors launch ``vap_w8a8`` (x
    bf16, w_i8 [N, K] int8, shapes ``supported``); CPU tensors take
    ``int8_linear_chunk_plain``."""
    if x.device.type == "cpu":
        return int8_linear_chunk_plain(x, w_i8, s_w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear_chunk: tensors on {x.device} are not supported")
    if not supported(w_i8, x):
        raise ValueError(f"int8_linear_chunk: weight {tuple(w_i8.shape)} and input "
                         f"{tuple(x.shape)} are not tileable (K and N to >= 128)")
    n, k = w_i8.shape
    chunk = _pick(k, BLOCK_K)
    x2d = x.reshape(-1, k)
    if not x2d.is_contiguous():
        x2d = x2d.contiguous()
    m = x2d.shape[0]
    if m < 1:
        raise ValueError(f"int8_linear_chunk: needs M >= 1, got {m}")
    bias32 = None if bias is None else bias.float().contiguous()
    _check_kernel_inputs(x2d, w_i8, s_w, bias32)
    x_i8 = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s_x = torch.empty((m, k // chunk), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("w8a8")
    with torch.cuda.device(x.device):
        err = lib.vap_w8a8(x2d.data_ptr(), w_i8.data_ptr(), s_w.data_ptr(),
                           None if bias32 is None else bias32.data_ptr(), x_i8.data_ptr(),
                           s_x.data_ptr(), out.data_ptr(), m, n, k, chunk,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "vap_w8a8")
    int8_linear_chunk.launches += 1
    return out.reshape(*x.shape[:-1], n)


int8_linear_chunk.launches = 0
