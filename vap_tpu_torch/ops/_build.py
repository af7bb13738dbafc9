"""Build the port's CUDA kernels and load them with ctypes.

Every ``vap_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, under
``build/vap_tpu_torch/`` at the root of the checkout. The library's name
carries a hash of the sources and flags, so an edited source builds anew and
an unchanged one is loaded as it is. Nothing is built when this module is
imported: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vap_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points in csrc/*.cu
_SIGNATURES = {
    # q, k, v, o, lse, bh, sq, skv, d, scale_log2, stream
    "vap_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q8, k8, sqk, v, o, lse, bh, sq, skv, d, stream
    "vap_sage_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """Path of the shared library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvap_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.

    The compiler's output (ptxas register and spill counts included) is kept
    beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
