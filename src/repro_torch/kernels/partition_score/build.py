"""Build and load the partition-score kernel library.

``nvcc`` compiles ``csrc/partition_score.cu`` into a shared library with a
plain C interface on first use (never at import) and :mod:`ctypes` loads it.
The library goes to ``build/kernels/`` at the repository root and is rebuilt
when the source is newer than it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "partition_score.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
LIBRARY = BUILD_DIR / "libpartition_score.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
# what the last build printed (ptxas register/shared-memory report) and took
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernel")


def build() -> Path:
    """Compile the library unless an up-to-date one exists; returns its path."""
    global build_log, build_seconds
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent build never sees half a file
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p = ctypes.c_void_p
        i, f = ctypes.c_int, ctypes.c_float
        lib.partition_score_gather.argtypes = [p, p, p, p, i, p, i, f, f, p, p]
        lib.partition_score_gather.restype = i
        lib.partition_score_dense.argtypes = [p, i, i, p, i, f, f, p, p]
        lib.partition_score_dense.restype = i
        _lib = lib
    return _lib
