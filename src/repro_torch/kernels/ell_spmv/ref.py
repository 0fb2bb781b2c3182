"""Plain PyTorch versions of the gather/reduce kernel.

``out[r] = reduce_{j in row r} x[col_j]`` for ``reduce`` in ``{"sum",
"min"}``. Sums accumulate in float64 and round once to float32, as the
kernel does, so the two agree to within one float rounding. The wrappers in
``ops.py`` take these for CPU tensors; the tests and ``chip_smoke.py`` hold
the kernel against them.
"""
from __future__ import annotations

import torch


def ell_spmv_ref(x: torch.Tensor, cols: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """The JAX signature: ``x`` f32[V+1] (identity at ``x[V]``), ``cols``
    int32[R, D] with pads pointing at ``V``; returns f32[R]."""
    vals = x[cols.long()]
    if reduce == "sum":
        return vals.double().sum(1).to(torch.float32)
    return vals.amin(1)


def segment_entries(row_ptr: torch.Tensor, e_max: int):
    """``(rows, pos)`` of the real entries of ``k`` devices' CSR rows:
    ``row_ptr`` int64[k, v_max+1] indexes each device's ``e_max`` slots;
    entry ``i`` belongs to flat row ``rows[i] = p*v_max + r`` and sits at flat
    slot ``pos[i] = p*e_max + j``."""
    k = row_ptr.shape[0]
    dev = row_ptr.device
    counts = (row_ptr[:, 1:] - row_ptr[:, :-1]).reshape(-1)
    rows = torch.repeat_interleave(
        torch.arange(counts.shape[0], dtype=torch.int64, device=dev), counts
    )
    # flat slot of each row's first entry, minus that entry's rank among all
    # real entries
    start = (row_ptr[:, :-1] + e_max * torch.arange(k, dtype=torch.int64, device=dev)[:, None])
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rows.shape[0], dtype=torch.int64, device=dev)
    pos += (start.reshape(-1) - first)[rows]
    return rows, pos


def ell_spmv_segments_ref(x: torch.Tensor, row_ptr: torch.Tensor, cols: torch.Tensor,
                          reduce: str = "sum") -> torch.Tensor:
    """The engine's call: ``x`` f32[k, state_len], ``row_ptr`` int64[k,
    v_max+1], ``cols`` int32[k, e_max]; returns f32[k, v_max]. Device ``p``'s
    row ``r`` reduces ``x[p, cols[p, row_ptr[p, r]:row_ptr[p, r+1]]]``; min
    starts every row from ``x[p, -1]`` (the identity slot), sum from 0. A
    gather, then ``index_add_`` or ``scatter_reduce_``."""
    k, state_len = x.shape
    v_max = row_ptr.shape[1] - 1
    rows, pos = segment_entries(row_ptr, cols.shape[1])
    flat = (pos // cols.shape[1]) * state_len + cols.reshape(-1)[pos].long()
    vals = x.reshape(-1)[flat]
    if reduce == "sum":
        out = torch.zeros(k * v_max, dtype=torch.float64, device=x.device)
        return out.index_add_(0, rows, vals.double()).to(torch.float32).reshape(k, v_max)
    out = x[:, -1:].expand(k, v_max).reshape(-1).clone()
    out.scatter_reduce_(0, rows, vals, "amin", include_self=True)
    return out.reshape(k, v_max)
