"""Carry state from plain arrays into the port.

The reference package's graphs and partition states are numpy arrays; these
functions build the port's counterparts from such arrays, so a caller can
run both packages on the same data without the port importing the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.base import PartitionState
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph

__all__ = ["graph_from_arrays", "state_from_arrays"]


def graph_from_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    device: str | torch.device | None = None,
) -> CSRGraph:
    """A :class:`CSRGraph` over copies of ``indptr`` (int64) and ``indices``
    (int32), with its arrays also placed on ``device``."""
    indptr = np.array(indptr, dtype=np.int64)
    indices = np.array(indices, dtype=np.int32)
    if indptr.ndim != 1 or indptr.shape[0] < 1 or indices.ndim != 1:
        raise ValueError("indptr and indices must be 1-D, indptr non-empty")
    if indptr[0] != 0 or indptr[-1] != indices.shape[0] or (np.diff(indptr) < 0).any():
        raise ValueError("indptr must rise from 0 to len(indices)")
    if indices.size and (indices.min() < 0 or indices.max() >= indptr.shape[0] - 1):
        raise ValueError("indices must be vertex ids in [0, |V|)")
    graph = CSRGraph(indptr=indptr, indices=indices)
    graph.to(resolve_device(device))
    return graph


def state_from_arrays(
    part_of: np.ndarray,
    v_counts: np.ndarray,
    e_counts: np.ndarray,
    *,
    k: int,
    epsilon: float,
    balance_mode: str,
    seed: int,
    total_degree: int,
    device: str | torch.device | None = None,
) -> PartitionState:
    """A :class:`PartitionState` holding copies of the arrays, with its
    ``part_of`` mirror on ``device`` and a fresh ``default_rng(seed)``
    tie-break generator."""
    part_of = np.asarray(part_of)
    if part_of.ndim != 1 or (part_of.size and (part_of.min() < -1 or part_of.max() >= k)):
        raise ValueError("part_of must be 1-D with ids in [-1, k)")
    if np.shape(v_counts) != (k,) or np.shape(e_counts) != (k,):
        raise ValueError(f"v_counts and e_counts must have shape ({k},)")
    return PartitionState.from_arrays(
        part_of,
        v_counts,
        e_counts,
        k=k,
        total_degree=total_degree,
        epsilon=epsilon,
        balance_mode=balance_mode,
        seed=seed,
        device=resolve_device(device),
    )
