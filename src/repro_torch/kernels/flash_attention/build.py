"""The attention kernel library: ``csrc/flash_attention.cu`` built into
``build/kernels/libflash_attention.so`` on first use (see
:mod:`repro_torch.kernels.nvcc`)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import KernelLibrary

_p, _i, _l, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    "flash_attention",
    {
        "flash_attention_fwd": [_i, _i, _i, _p, _p, _p, _p, _p, _l, _l, _l, _l, _l, _i, _l,
                                _l, _f, _p, _i, _p],
        "flash_decode_blocks_per_sm": [_i, _i, _l, ctypes.POINTER(_i)],
    },
)
library = LIBRARY.load
