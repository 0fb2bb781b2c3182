"""The gather/reduce kernel library: ``csrc/ell_spmv.cu`` built into
``build/kernels/libell_spmv.so`` on first use (see
:mod:`repro_torch.kernels.nvcc`)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import KernelLibrary

_p, _i, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "ell_spmv.cu",
    "ell_spmv",
    {
        "ell_spmv_segments": [_p, _p, _p, _l, _l, _l, _l, _i, _p, _p],
        "ell_spmv_ell": [_p, _p, _l, _l, _i, _p, _p],
    },
)
library = LIBRARY.load
