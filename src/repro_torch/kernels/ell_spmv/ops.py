"""Wrappers of the gather/reduce kernel.

A CUDA tensor goes to the hand-written Hopper kernel (``csrc/ell_spmv.cu``)
or the call raises; a CPU tensor takes the plain PyTorch version in
``ref.py``. There is no fallback from one to the other. ``launches`` counts
the kernel's launches from both entries (``ell_spmv``, the JAX signature,
and ``ell_spmv_segments``, the engine's call); CPU calls do not count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_tensor as _check
from repro_torch.kernels.ell_spmv import build
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref, ell_spmv_segments_ref

__all__ = ["ITEMS_PER_THREAD", "REDUCES", "THREADS", "TILE", "ell_spmv", "ell_spmv_segments",
           "launches", "reset", "tiles"]

REDUCES = {"sum": 0, "min": 1}
# the kernel's merge-path tiling (csrc/ell_spmv.cu's kThreads and
# kItemsPerThread): a block takes TILE items of a device's rows + entries
THREADS = 256
ITEMS_PER_THREAD = 8
TILE = THREADS * ITEMS_PER_THREAD
launches = 0


def tiles(rows: int, entries: int) -> int:
    """Blocks the kernel gives one device whose path holds ``rows`` row ends
    and at most ``entries`` entries: one per ``TILE`` items. Raises where
    the kernel's 32-bit offsets within a device would not hold."""
    path = rows + entries
    if path + TILE >= 2**31:
        raise ValueError(f"{rows} rows and {entries} entries exceed the kernel's 32-bit "
                         f"offsets (rows + entries must stay below {2**31 - TILE})")
    return -(-path // TILE)


def reset() -> None:
    """Zero the launch count."""
    global launches
    launches = 0


def _check_reduce(reduce: str) -> int:
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {sorted(REDUCES)}, got {reduce!r}")
    return REDUCES[reduce]


def _launch(fn, *args) -> None:
    global launches
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {err}")
    launches += 1


def ell_spmv(x: torch.Tensor, cols: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """``out[r] = reduce_d x[cols[r, d]]``: ``x`` f32[V+1] with the
    reduction's identity at ``x[V]``, ``cols`` int32[R, D] (D >= 1) with pads
    pointing at ``V``; returns f32[R] (the reference's ``ell_spmv``
    signature). Column values are the caller's to keep in ``[0, V]``; they
    are not checked on the card, where that would cost a synchronisation."""
    device = x.device
    _check("x", x, torch.float32, 1, device)
    _check("cols", cols, torch.int32, 2, device)
    code = _check_reduce(reduce)
    r, d = cols.shape
    if d < 1:
        raise ValueError("cols needs at least one column")
    if device.type == "cpu":
        return ell_spmv_ref(x, cols, reduce)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty(r, dtype=torch.float32, device=device)
    if r:
        tiles(r, r * d)
        _launch(build.library().ell_spmv_ell, x.data_ptr(), cols.data_ptr(), r, d, code,
                out.data_ptr())
    return out


def ell_spmv_segments(x: torch.Tensor, row_ptr: torch.Tensor, cols: torch.Tensor,
                      reduce: str = "sum") -> torch.Tensor:
    """f32[k, v_max] for the CSR rows of ``k`` devices in one call (the
    analytics engine's, once per iteration): device ``p``'s row ``r``
    reduces ``x[p, cols[p, row_ptr[p, r]:row_ptr[p, r+1]]]``. ``x`` is
    f32[k, state_len] with the identity at ``x[p, -1]``; an empty row gives
    0 for sum and ``x[p, -1]`` for min. ``row_ptr`` (int64[k, v_max+1],
    rising from 0 to at most ``e_max``) and the column values (in ``[0,
    state_len)``) are the caller's to keep; they are not checked on the
    card."""
    device = x.device
    _check("x", x, torch.float32, 2, device)
    _check("row_ptr", row_ptr, torch.int64, 2, device)
    _check("cols", cols, torch.int32, 2, device)
    code = _check_reduce(reduce)
    k, state_len = x.shape
    if row_ptr.shape[0] != k or cols.shape[0] != k:
        raise ValueError(
            f"x, row_ptr and cols must have the same device count, got "
            f"{k}, {row_ptr.shape[0]}, {cols.shape[0]}"
        )
    if row_ptr.shape[1] < 1 or state_len < 1:
        raise ValueError("row_ptr needs v_max+1 >= 1 entries and x at least the identity slot")
    v_max = row_ptr.shape[1] - 1
    if device.type == "cpu":
        return ell_spmv_segments_ref(x, row_ptr, cols, reduce)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((k, v_max), dtype=torch.float32, device=device)
    if k and v_max:
        tiles(v_max, cols.shape[1])
        _launch(build.library().ell_spmv_segments, x.data_ptr(), row_ptr.data_ptr(),
                cols.data_ptr(), k, v_max, state_len, cols.shape[1], code, out.data_ptr())
    return out
