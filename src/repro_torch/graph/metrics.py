"""Partition quality metrics (port of ``repro.graph.metrics``, paper §II).

The scans run in torch on the device that holds the graph. Every count is an
exact integer (the edge-mass sums are integer-valued float64), and the final
ratios are formed in Python doubles the same way the reference forms them,
so the report equals the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph


def quality_report(
    graph: CSRGraph, part: np.ndarray, k: int, device: torch.device
) -> dict:
    """λ_EC (Eq. 3), λ_CV (Eq. 4), vertex and edge imbalance of ``part``."""
    part = np.asarray(part)
    if part.shape != (graph.num_vertices,):
        raise ValueError(
            f"assignment has shape {part.shape}, expected ({graph.num_vertices},)"
        )
    if part.size and (part.min() < 0 or part.max() >= k):
        raise ValueError("invalid partition ids")
    g = graph.to(device)
    p = torch.from_numpy(part.astype(np.int64)).to(g.device)
    src = g.sources()
    pd = p[g.indices.long()]
    n = max(graph.num_vertices, 1)

    # edge-cut: symmetric storage counts every cut edge twice
    cut = int((p[src] != pd).sum()) // 2
    # communication volume: unique (u, neighbour-partition) pairs outside u's
    # own partition
    uniq = torch.unique(src * k + pd)
    external = int((uniq % k != p[uniq // k]).sum())

    v_counts = torch.bincount(p, minlength=k)
    e_counts = torch.zeros(k, dtype=torch.float64, device=g.device)
    e_counts.index_add_(0, p, g.degrees().to(torch.float64))
    return {
        "k": k,
        "edge_cut": cut / max(graph.num_edges, 1),
        "comm_volume": external / (k * n),
        "vertex_imbalance": _imbalance(v_counts, k),
        "edge_imbalance": _imbalance(e_counts, k),
    }


def _imbalance(counts: torch.Tensor, k: int) -> float:
    # max over mean; the sum of integer-valued counts is exact in any order
    mean = float(counts.sum().item()) / k
    return float(np.float64(counts.max().item()) / max(mean, 1e-12))
