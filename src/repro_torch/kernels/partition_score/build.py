"""The partition-score kernel library: ``csrc/partition_score.cu`` built
into ``build/kernels/libpartition_score.so`` on first use (see
:mod:`repro_torch.kernels.nvcc`)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import KernelLibrary

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "partition_score.cu",
    "partition_score",
    {
        "partition_score_gather": [_p, _p, _p, _p, _i, _p, _i, _f, _f, _p, _p],
        "partition_score_dense": [_p, _i, _i, _p, _i, _f, _f, _p, _p],
        "partition_score_sharded_gather": [_p, _p, _p, _p, _p, _i, _i, _p, _i, _f, _f, _p, _p],
        "partition_score_sharded_dense": [_p, _i, _i, _i, _p, _i, _f, _f, _p, _p],
    },
)
library = LIBRARY.load
