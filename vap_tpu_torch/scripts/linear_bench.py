"""Microbench of the W8A8 projection path at bench shapes, on one GPU.

    python -m vap_tpu_torch.scripts.linear_bench [--m M] [--k K] [--n N]
        [--impl all|kernel|diag|nsweep]

The port of ``scripts/linear_bench.py``. At the joint-attention token count
of a CFG-2 CogVideoX step (M = 71,168, d = 3,072) it times, with CUDA
events after a warm-up:

  * ``all``:    bf16 dense (``torch.matmul``), the int8 product
                (``torch._int_mm``), the row form (``int8_linear_row``, the
                JAX package's ``_int8_linear``) and K3 (``int8_linear_chunk``);
  * ``kernel``: K3 alone (the JAX script's ``pallas``);
  * ``diag``:   the tiled GEMM rate probe, K9 (x [M, K]) and K10 (x given
                as xt [K, M]), each in int8 and in bf16, with its tile and
                the bytes of K a stage of its ring holds;
  * ``nsweep``: bf16 dense and the int8 product at N = 6,144 and 12,288.

Each line gives ms per call and TOP/s (2MNK operations). Weights are
[N, K] (nn.Linear's layout). It runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Callable, List, Optional

import torch

from ..models.common import int8_linear_row, quantize_linear_int8
from ..ops import int8_matmul
from ..ops.gemm_probe import TILE_K_BYTES, TILE_M, TILE_N, gemm_probe, gemm_probe_t
from ..ops.int8_matmul import int8_linear_chunk

REPS = 5


def timed_ms(fn: Callable[[], torch.Tensor], reps: int = REPS) -> float:
    """ms per call: one warm-up call, then ``reps`` calls between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _line(label: str, ms: float, ops: float) -> str:
    return f"{label}: {ms:8.3f} ms  {ops / (ms * 1e-3) / 1e12:7.1f} TOP/s"


def run(m: int, k: int, n: int, impl: str, device: torch.device) -> List[str]:
    """The lines of ``impl`` at [m, k] x [k, n], in order."""
    ops = 2.0 * m * k * n
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    w_i8, s_w = quantize_linear_int8(w)
    x_i8 = (x.float() * 0.3).round().to(torch.int8)
    lines = []
    if impl == "all":
        lines.append(_line("bf16 dense (torch.matmul)  ", timed_ms(lambda: torch.matmul(x, w.T)), ops))
        lines.append(_line("int8 dot (torch._int_mm)   ",
                           timed_ms(lambda: torch._int_mm(x_i8, w_i8.T)), ops))
        lines.append(_line("row form (int8_linear_row) ",
                           timed_ms(lambda: int8_linear_row(x, w_i8, s_w)), ops))
    if impl in ("all", "kernel"):
        k3_tile = f"tile {int8_matmul.TILE_M}x{int8_matmul.TILE_N}"
        lines.append(_line(f"K3 W8A8 (int8_linear_chunk, {k3_tile})",
                           timed_ms(lambda: int8_linear_chunk(x, w_i8, s_w)), ops))
    if impl == "diag":
        tile = f"tile {TILE_M}x{TILE_N}, K by {TILE_K_BYTES} bytes a stage"
        xt_i8, xt = x_i8.T.contiguous(), x.T.contiguous()
        lines.append(_line(f"K9  i8 dot   ({tile})", timed_ms(lambda: gemm_probe(x_i8, w_i8)), ops))
        lines.append(_line(f"K9  bf16 dot ({tile})", timed_ms(lambda: gemm_probe(x, w)), ops))
        lines.append(_line(f"K10 i8 dotT  ({tile})", timed_ms(lambda: gemm_probe_t(xt_i8, w_i8)),
                           ops))
        lines.append(_line(f"K10 bf16dotT ({tile})", timed_ms(lambda: gemm_probe_t(xt, w)), ops))
    if impl == "nsweep":
        for nn in (6144, 12288):
            wn = (torch.randn((nn, k), generator=gen, device=device) * 0.02).to(torch.bfloat16)
            wn_i8 = (wn.float() * 50).round().to(torch.int8)
            ops_n = 2.0 * m * k * nn
            lines.append(_line(f"bf16 dense N={nn}", timed_ms(lambda: torch.matmul(x, wn.T)), ops_n))
            lines.append(_line(f"int8 dot  N={nn}", timed_ms(lambda: torch._int_mm(x_i8, wn_i8.T)),
                               ops_n))
    return lines


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=71168)  # 2*2*(226+17550) rounded to 512
    ap.add_argument("--k", type=int, default=3072)
    ap.add_argument("--n", type=int, default=3072)
    ap.add_argument("--impl", default="all", choices=("all", "kernel", "diag", "nsweep"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("linear_bench: no CUDA device; this measures the card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi}); M={args.m} K={args.k} N={args.n}; tiles: "
          f"K3 {int8_matmul.TILE_M}x{int8_matmul.TILE_N}, K9/K10 {TILE_M}x{TILE_N}", flush=True)
    lines = run(args.m, args.k, args.n, args.impl, device)
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    main()
