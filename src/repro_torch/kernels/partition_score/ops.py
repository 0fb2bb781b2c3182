"""Wrappers of the partition-score kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/partition_score.cu``) or the call raises; a CPU tensor takes the
plain PyTorch version in ``ref.py``. There is no fallback from one to the
other. ``launches`` counts the launches of the sequential entries
(``fennel_scores``, ``fennel_scores_gather``; the port of
``fennel_scores_pallas``), ``sharded_launches`` those of the sharded entries
(``fennel_scores_sharded``, ``fennel_scores_sharded_gather``; the port of
``fennel_scores_sharded_pallas``). CPU calls count in neither.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_tensor as _check
from repro_torch.kernels.partition_score import build
from repro_torch.kernels.partition_score.ref import (
    fennel_scores_gather_ref,
    fennel_scores_ref,
    fennel_scores_sharded_gather_ref,
    fennel_scores_sharded_ref,
)

__all__ = [
    "MAX_K",
    "fennel_scores",
    "fennel_scores_gather",
    "fennel_scores_sharded",
    "fennel_scores_sharded_gather",
    "launches",
    "reset",
    "sharded_launches",
]

# K int32 counters live in 48 KB of shared memory (csrc kMaxK)
MAX_K = 12288
# a launch's grid has one block per row; rows are indexed by a C int
_MAX_ROWS = 2**31 - 1
launches = 0
sharded_launches = 0


def reset() -> None:
    """Zero the launch counts."""
    global launches, sharded_launches
    launches = 0
    sharded_launches = 0


def _check_k(sizes: torch.Tensor) -> int:
    k = sizes.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K must be in [1, {MAX_K}], got {k}")
    return k


def _check_graph(indptr, indices, part_of, batch, device) -> None:
    _check("indptr", indptr, torch.int64, 1, device)
    _check("indices", indices, torch.int32, 1, device)
    _check("part_of", part_of, torch.int32, 1, device)
    _check("batch", batch, torch.int64, 1, device)
    if part_of.shape[0] != indptr.shape[0] - 1:
        raise ValueError(
            f"part_of has {part_of.shape[0]} entries for a graph of "
            f"{indptr.shape[0] - 1} vertices"
        )
    if batch.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per call, got {batch.shape[0]}")


def _launch(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"partition_score kernel launch failed: CUDA error {err}")


def fennel_scores_gather(
    indptr: torch.Tensor,  # int64[V+1]
    indices: torch.Tensor,  # int32[nnz]
    part_of: torch.Tensor,  # int32[V], -1 = unassigned
    batch: torch.Tensor,  # int64[C] vertex ids of the rows
    sizes: torch.Tensor,  # float32[K]
    alpha: float,
    gamma: float,
) -> torch.Tensor:
    """scores f32[C, K] for the CSR rows of ``batch`` (the engine's call)."""
    global launches
    device = indptr.device
    _check_graph(indptr, indices, part_of, batch, device)
    _check("sizes", sizes, torch.float32, 1, device)
    k = _check_k(sizes)
    if device.type == "cpu":
        return fennel_scores_gather_ref(indptr, indices, part_of, batch, sizes, alpha, gamma)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    c = batch.shape[0]
    out = torch.empty((c, k), dtype=torch.float32, device=device)
    if c:
        _launch(
            build.library().partition_score_gather,
            indptr.data_ptr(), indices.data_ptr(), part_of.data_ptr(),
            batch.data_ptr(), c, sizes.data_ptr(), k,
            float(alpha * gamma), float(gamma - 1.0), out.data_ptr(),
        )
        launches += 1
    return out


def fennel_scores(
    nbr_parts: torch.Tensor,  # int32[B, D], -1 padding
    sizes: torch.Tensor,  # float32[K]
    alpha: float,
    gamma: float = 1.5,
) -> torch.Tensor:
    """scores f32[B, K] for a dense matrix of neighbour partition ids (the
    reference's ``fennel_scores`` signature)."""
    global launches
    device = nbr_parts.device
    _check("nbr_parts", nbr_parts, torch.int32, 2, device)
    _check("sizes", sizes, torch.float32, 1, device)
    k = _check_k(sizes)
    if device.type == "cpu":
        return fennel_scores_ref(nbr_parts, sizes, alpha, gamma)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    b, d = nbr_parts.shape
    out = torch.empty((b, k), dtype=torch.float32, device=device)
    if b:
        _launch(
            build.library().partition_score_dense,
            nbr_parts.data_ptr(), b, d, sizes.data_ptr(), k,
            float(alpha * gamma), float(gamma - 1.0), out.data_ptr(),
        )
        launches += 1
    return out


def fennel_scores_sharded_gather(
    indptr: torch.Tensor,  # int64[V+1]
    indices: torch.Tensor,  # int32[nnz]
    part_of: torch.Tensor,  # int32[V], -1 = unassigned
    batch: torch.Tensor,  # int64[total] candidates, shard after shard
    shard_start: torch.Tensor,  # int64[S+1] first row of each shard, then total
    sizes: torch.Tensor,  # float32[S, K] one size row per shard
    alpha: float,
    gamma: float,
) -> torch.Tensor:
    """scores f32[total, K] for the CSR rows of a superstep's candidates;
    row ``r`` is penalised by the size row of the shard that holds it (the
    parallel engine's call, one per superstep).

    ``shard_start`` must rise from 0 to ``total``; an empty shard repeats a
    bound. Its values are checked here for a CPU tensor only: reading them
    from the card would cost a synchronisation per superstep, and the kernel
    clamps the shard it finds, so a bad ``shard_start`` there picks a wrong
    size row but reads nothing out of bounds."""
    global sharded_launches
    device = indptr.device
    _check_graph(indptr, indices, part_of, batch, device)
    _check("shard_start", shard_start, torch.int64, 1, device)
    _check("sizes", sizes, torch.float32, 2, device)
    k = _check_k(sizes)
    s = sizes.shape[0]
    if s < 1 or shard_start.shape[0] != s + 1:
        raise ValueError(
            f"shard_start must have S+1 = {s + 1} entries for {s} size rows, "
            f"got {shard_start.shape[0]}"
        )
    total = batch.shape[0]
    if device.type == "cpu":
        if (
            int(shard_start[0]) != 0
            or int(shard_start[-1]) != total
            or bool((shard_start[1:] < shard_start[:-1]).any())
        ):
            raise ValueError(f"shard_start must rise from 0 to {total}")
        return fennel_scores_sharded_gather_ref(
            indptr, indices, part_of, batch, shard_start, sizes, alpha, gamma
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((total, k), dtype=torch.float32, device=device)
    if total:
        _launch(
            build.library().partition_score_sharded_gather,
            indptr.data_ptr(), indices.data_ptr(), part_of.data_ptr(),
            batch.data_ptr(), shard_start.data_ptr(), s, total,
            sizes.data_ptr(), k, float(alpha * gamma), float(gamma - 1.0),
            out.data_ptr(),
        )
        sharded_launches += 1
    return out


def fennel_scores_sharded(
    nbr_parts: torch.Tensor,  # int32[S, C, D], -1 padding
    sizes: torch.Tensor,  # float32[S, K]
    alpha: float,
    gamma: float = 1.5,
) -> torch.Tensor:
    """scores f32[S, C, K]: shard ``s`` scores its rows against its own size
    row (the reference's ``fennel_scores_sharded`` signature)."""
    global sharded_launches
    device = nbr_parts.device
    _check("nbr_parts", nbr_parts, torch.int32, 3, device)
    _check("sizes", sizes, torch.float32, 2, device)
    k = _check_k(sizes)
    s, c, d = nbr_parts.shape
    if sizes.shape[0] != s:
        raise ValueError(f"sizes has {sizes.shape[0]} size rows for {s} shards")
    if s * c > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per call, got {s * c}")
    if device.type == "cpu":
        return fennel_scores_sharded_ref(nbr_parts, sizes, alpha, gamma)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((s, c, k), dtype=torch.float32, device=device)
    if s * c:
        _launch(
            build.library().partition_score_sharded_dense,
            nbr_parts.data_ptr(), s, c, d, sizes.data_ptr(), k,
            float(alpha * gamma), float(gamma - 1.0), out.data_ptr(),
        )
        sharded_launches += 1
    return out
