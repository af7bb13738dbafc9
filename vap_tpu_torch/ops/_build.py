"""Build the port's CUDA kernels and load them with ctypes.

Each ``vap_tpu_torch/csrc/<name>.cu`` file is compiled by its own ``nvcc``
process for ``sm_90a`` into a shared library with a plain C interface,
under ``build/vap_tpu_torch/`` at the root of the checkout; the processes
run side by side, so a build takes as long as its slowest source. A
library's name carries a hash of its source, the shared headers and the
flags, so an edited source builds anew and an unchanged one is loaded as it
is. Nothing is built when this module is imported: the first kernel launch
builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vap_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points, by source file (csrc/<source>.cu)
SOURCES = {
    "flash_fwd": {
        # q, k, v, o, lse, kv_lens (or null), bh, heads, sq, skv, d, scale_log2, stream
        "vap_flash_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        # q, k, v, q_seg, kv_seg, o, lse, bh, heads, sq, skv, d, scale_log2, stream (K8 at the
        # head dims of no model)
        "vap_flash_fwd_seg": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    },
    "sage_fwd": {
        # q8, k8, sqk, v, o, lse, kv_lens (or null), bh, heads, sq, skv, d, stream (K2 and K7's
        # int8 form at head_dim 32 and 96)
        "vap_sage_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "sage_fwd_sm90": {
        # q8, k8, sqk, v, o, lse, kv_lens (or null), bh, heads, sq, skv, stream (K2, K7's int8
        # form at head_dim 128)
        "vap_sage_fwd_d128": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "sage_fwd_sm90_d64": {
        # the same at head_dim 64
        "vap_sage_fwd_d64": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "sage_quant": {
        # q, k, kv_lens (or null), q8, k8, sqk, scratch, bh, heads, sq, skv, d, chunks, scale,
        # stream (K2's pre-pass)
        "vap_sage_quant": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "flash_bwd": {
        # q, k, v, dout, lse, delta, dq, dk, dv, kv_lens (or null), bh, heads, sq, skv, d,
        # scale_log2, scale, stream
        "vap_flash_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
        # q, k, v, dout, lse, delta, dq, dk, dv, q_seg, kv_seg, bh, heads, sq, skv, d,
        # scale_log2, scale, stream (K8 at the head dims of no model)
        "vap_flash_bwd_seg": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                              _F, _P),
    },
    "flash_fwd_sm90": {
        # q, k, v, o, lse, kv_lens (or null), bh, heads, sq, skv, scale_log2, stream (K4, K7)
        "vap_flash_fwd_d128": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        # q, k, v, q_seg, kv_seg, ranges (scratch), o, lse, bh, heads, sq, skv, scale_log2, stream
        # (K8)
        "vap_flash_fwd_d128_seg": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        # tiles: int[2], K8's (query block, key tile) rows
        "vap_flash_fwd_d128_seg_tiles": (_P,),
    },
    "flash_fwd_sm90_d64": {
        # q, k, v, o, lse, kv_lens (or null), bh, heads, sq, skv, scale_log2, stream (K1, K7 at
        # head_dim 64)
        "vap_flash_fwd_d64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        # the same as vap_flash_fwd_d128_seg at head_dim 64 (K8)
        "vap_flash_fwd_d64_seg": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        "vap_flash_fwd_d64_seg_tiles": (_P,),
    },
    "flash_bwd_sm90_d64": {
        # q, k, v, dout, lse, delta, dq, dk, dv, kv_lens (or null), bh, heads, sq, skv,
        # scale_log2, scale, stream (K5, K7's backward at head_dim 64)
        "vap_flash_bwd_d64": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
        # q, k, v, dout, lse, delta, dq, dk, dv, q_seg, kv_seg, ranges (scratch), bh, heads, sq,
        # skv, scale_log2, scale, stream (K8's backward)
        "vap_flash_bwd_d64_seg": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _F, _F, _P),
        "vap_flash_bwd_d64_seg_tiles": (_P,),
    },
    "flash_bwd_sm90": {
        # q, k, v, dout, lse, delta, dq, dk, dv, kv_lens (or null), bh, heads, sq, skv, scale,
        # stream (K6, K7's backward)
        "vap_flash_bwd_d128": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        # q, k, v, dout, lse, delta, dq, dk, dv, q_seg, kv_seg, ranges (scratch), bh, heads, sq,
        # skv, scale, stream (K8's backward)
        "vap_flash_bwd_d128_seg": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _F, _P),
        # tiles: int[4], K8's dq (query block, key tile) and dk/dv (key block, query tile) rows
        "vap_flash_bwd_d128_seg_tiles": (_P,),
    },
    "w8a8": {
        # x, w, sw, bias (or null), xq, sx, out, m, n, k, chunk, stream
        "vap_w8a8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "gemm_probe": {
        # a, b, out, m, n, k, bf16, trans_a, stream
        "vap_gemm_probe": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
        # src, dst, rows, cols, stream (K10 in int8: xt [K, M] -> x [M, K])
        "vap_transpose_i8": (_P, _P, _I, _I, _P),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    """Path of the shared library of ``csrc/<source>.cu`` (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{source}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{source}_{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every source whose library does not exist yet, one ``nvcc``
    process per source, all started together; raise if any fails.

    Each compiler's output (ptxas register and spill counts included) is
    kept beside its library as ``<name>.log``. Returns {source: library}."""
    out = {source: library_path(source) for source in SOURCES}
    todo = {s: p for s, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for source, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{source}.cu")]
        procs[source] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    failed = []
    for source, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        path = todo[source]
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{source}.cu: nvcc exit code {proc.returncode}\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>.cu``, with
    the argtypes of its entry points set."""
    lib = ctypes.CDLL(str(build()[source]))
    for name, argtypes in SOURCES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
