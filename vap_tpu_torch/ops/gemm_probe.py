"""The tiled GEMM rate probe (K9, K10) and its plain PyTorch versions.

Port of the two Pallas kernels of ``scripts/linear_bench.py --impl diag``:
K9 ``gemm_probe`` (``run``, ``dot_kernel``: x [M, K]) and K10
``gemm_probe_t`` (``run_t``, ``dot_t_kernel``: x given transposed as
xt [K, M]). Both compute ``x @ w^T`` for a weight w [N, K]: int8 inputs
give the exact int32 product, bf16 inputs an f32 sum rounded to bf16. They
measure the card's tensor-core rate, the yardstick of K3's bound; no model
path calls them. CUDA source: ``csrc/gemm_probe.cu``, the ``wgmma`` main
loop of ``csrc/gemm_sm90.cuh`` (TMA, a persistent grid) in three kernels:
int8, bf16, and bf16 with xt read MN-major. 8-bit ``wgmma`` takes no
MN-major operand, so K10 in int8 first transposes xt into a scratch [M, K]
(``vap_transpose_i8``, a hand-written kernel) and then runs K9's int8
kernel; the wrapper allocates the scratch and counts the pair as one
launch. CUDA tensors launch the kernels, CPU tensors take the plain
version, any other device raises. Launches are counted on
``gemm_probe.launches`` and ``gemm_probe_t.launches``.
"""

from __future__ import annotations

import torch

from . import _build

# the output tile of csrc/gemm_probe.cu and the bytes of K a stage of its
# ring holds, which the probe script prints
TILE_M, TILE_N, TILE_K_BYTES = 128, 256, 128
_DTYPES = (torch.int8, torch.bfloat16)


def gemm_probe_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w[N, K]^T: int8 -> the exact int32 product (summed in
    float64, exact below 2^53), bf16 -> an f32 product rounded to bf16."""
    if x.dtype == torch.int8:
        return (x.double() @ w.double().T).to(torch.int32)
    return (x.float() @ w.float().T).to(torch.bfloat16)


def gemm_probe_t_plain(xt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K10's function: xt [K, M] -> xt^T @ w^T."""
    return gemm_probe_plain(xt.T, w)


def _launch(name: str, a: torch.Tensor, w: torch.Tensor, m: int, k: int, trans_a: bool):
    n = w.shape[0]
    for arg, t in (("x", a), ("w", w)):
        if t.device != a.device or t.dtype != a.dtype:
            raise ValueError(f"{name}: {arg} must be on {a.device} with dtype {a.dtype}")
        if t.ndim != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 2-D, contiguous and 16-byte aligned")
    if a.dtype not in _DTYPES:
        raise ValueError(f"{name}: takes int8 or bfloat16, got {a.dtype}")
    if w.shape[1] != k:
        raise ValueError(f"{name}: x has K={k}, w {tuple(w.shape)}")
    if k % 64 or n % 128 or m < 1 or (trans_a and m % 16):
        raise ValueError(f"{name}: needs K % 64 == 0, N % 128 == 0"
                         f"{', M % 16 == 0' if trans_a else ''}; got M={m}, K={k}, N={n}")
    int8 = a.dtype == torch.int8
    out = torch.empty((m, n), dtype=torch.int32 if int8 else torch.bfloat16, device=a.device)
    lib = _build.library("gemm_probe")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if trans_a and int8:  # xt [K, M] -> a scratch x [M, K], then K9's int8 kernel
            x = torch.empty((m, k), dtype=torch.int8, device=a.device)
            _build.check(lib.vap_transpose_i8(a.data_ptr(), x.data_ptr(), k, m, stream),
                         "vap_transpose_i8")
            a, trans_a = x, False
        err = lib.vap_gemm_probe(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                                 int(not int8), int(trans_a), stream)
    _build.check(err, "vap_gemm_probe")
    return out


def _device_kind(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {x.device} are not supported")
    return x.device.type


def gemm_probe(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K9: x [M, K] @ w [N, K]^T (int8 -> int32, bf16 -> bf16)."""
    if _device_kind("gemm_probe", x) == "cpu":
        return gemm_probe_plain(x, w)
    out = _launch("gemm_probe", x, w, x.shape[0], x.shape[1], trans_a=False)
    gemm_probe.launches += 1
    return out


gemm_probe.launches = 0


def gemm_probe_t(xt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K10: the same product with x given transposed, xt [K, M]."""
    if _device_kind("gemm_probe_t", xt) == "cpu":
        return gemm_probe_t_plain(xt, w)
    out = _launch("gemm_probe_t", xt, w, xt.shape[1], xt.shape[0], trans_a=True)
    gemm_probe_t.launches += 1
    return out


gemm_probe_t.launches = 0
