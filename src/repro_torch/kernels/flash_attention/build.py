"""The attention kernel libraries, built on first use (see
:mod:`repro_torch.kernels.nvcc`): ``csrc/flash_attention.cu`` (every variant
at Dqk = Dv) into ``build/kernels/libflash_attention.so``, and
``csrc/flash_attention_mla.cu`` (MLA's (Dqk, Dv) pairs) into
``libflash_attention_mla.so``; both instantiate the templates of
``csrc/flash_attention.cuh``, and each has its own ``nvcc``, so the two build
side by side."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import KernelLibrary

_p, _i, _l, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
CSRC = Path(__file__).resolve().parent / "csrc"
HEADER = CSRC / "flash_attention.cuh"

LIBRARY = KernelLibrary(
    CSRC / "flash_attention.cu",
    "flash_attention",
    {
        "flash_attention_fwd": [_i, _i, _i, _p, _p, _p, _p, _p, _l, _l, _l, _l, _l, _i, _l,
                                _l, _f, _p, _i, _p],
        "flash_decode_blocks_per_sm": [_i, _i, _l, ctypes.POINTER(_i)],
    },
    depends=(HEADER,),
)
MLA_LIBRARY = KernelLibrary(
    CSRC / "flash_attention_mla.cu",
    "flash_attention_mla",
    {
        "flash_attention_mla_fwd": [_i, _i, _i, _i, _p, _p, _p, _p, _p, _l, _l, _l, _l, _l,
                                    _i, _l, _l, _f, _p, _i, _p],
        "flash_latent_blocks_per_sm": [_i, _i, _i, _i, ctypes.POINTER(_i)],
    },
    depends=(HEADER,),
)
library = LIBRARY.load
mla_library = MLA_LIBRARY.load
