"""Build and load a kernel library written in CUDA C++ with a plain C interface.

``nvcc`` compiles one ``csrc/*.cu`` file into a shared library on first use
(never at import) and :mod:`ctypes` loads it. Libraries go to
``build/kernels/`` at the repository root and are rebuilt when their source,
or a header it names in ``depends``, is newer than them. Each kernel package
declares its library once::

    LIBRARY = KernelLibrary(SOURCE, "ell_spmv", {"ell_spmv_ell": [p, p, ...]})
    LIBRARY.load().ell_spmv_ell(...)

Every pointer and the stream are ``ctypes.c_void_p`` in the signatures, or
ctypes passes them as 32-bit ints and cuts them.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "KernelLibrary"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -split-compile=0: the device code's optimisation runs on every host core,
# not one (the attention library builds 85 kernel instances)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


class KernelLibrary:
    """One ``.cu`` source, its shared library and the C signatures of its
    entry points (``name -> argtypes``; every entry returns a CUDA error
    code as a C int); ``depends``: the headers the source includes."""

    def __init__(self, source: Path, name: str, signatures: dict[str, list],
                 depends: tuple = ()):
        self.source = Path(source)
        self.depends = tuple(Path(d) for d in depends)
        self.path = BUILD_DIR / f"lib{name}.so"
        self.signatures = dict(signatures)
        # what the last build printed (ptxas register/shared-memory report)
        # and how long nvcc took
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def build(self) -> Path:
        """Compile the library unless an up-to-date one exists; returns its
        path."""
        with self._lock:
            return self._build()

    def _build(self) -> Path:
        newest = max(f.stat().st_mtime for f in (self.source, *self.depends))
        if self.path.exists() and self.path.stat().st_mtime >= newest:
            return self.path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(f"{self.path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, self.path)  # atomic: a concurrent build never sees half a file
        return self.path

    def load(self) -> ctypes.CDLL:
        """The loaded library, built on first call."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self._build()))
                for fn, argtypes in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
            return self._lib
