"""Wrappers of the partition-score kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/partition_score.cu``) or the call raises; a CPU tensor takes the
plain PyTorch version in ``ref.py``. There is no fallback from one to the
other. ``launches`` counts kernel launches (CPU calls do not count).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.partition_score import build
from repro_torch.kernels.partition_score.ref import (
    fennel_scores_gather_ref,
    fennel_scores_ref,
)

__all__ = ["MAX_K", "fennel_scores", "fennel_scores_gather", "launches"]

# K int32 counters live in 48 KB of shared memory (csrc kMaxK)
MAX_K = 12288
launches = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_k(sizes: torch.Tensor) -> int:
    k = sizes.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K must be in [1, {MAX_K}], got {k}")
    return k


def _launch(fn, *args) -> None:
    global launches
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"partition_score kernel launch failed: CUDA error {err}")
    launches += 1


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
    device = indptr.device
    _check("indptr", indptr, torch.int64, 1, device)
    _check("indices", indices, torch.int32, 1, device)
    _check("part_of", part_of, torch.int32, 1, device)
    _check("batch", batch, torch.int64, 1, device)
    _check("sizes", sizes, torch.float32, 1, device)
    if part_of.shape[0] != indptr.shape[0] - 1:
        raise ValueError(
            f"part_of has {part_of.shape[0]} entries for a graph of "
            f"{indptr.shape[0] - 1} vertices"
        )
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
    return out


def fennel_scores(
    nbr_parts: torch.Tensor,  # int32[B, D], -1 padding
    sizes: torch.Tensor,  # float32[K]
    alpha: float,
    gamma: float = 1.5,
) -> torch.Tensor:
    """scores f32[B, K] for a dense matrix of neighbour partition ids (the
    reference's ``fennel_scores`` signature)."""
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
    return out
