"""The selective-scan kernel library: ``csrc/mamba_scan.cu`` built into
``build/kernels/libmamba_scan.so`` on first use (see
:mod:`repro_torch.kernels.nvcc`)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import KernelLibrary

_p, _i, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu",
    "mamba_scan",
    {"selective_scan_fwd": [_i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _l, _l, _l, _p]},
)
library = LIBRARY.load
