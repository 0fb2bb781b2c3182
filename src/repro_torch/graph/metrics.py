"""Partition quality metrics (port of ``repro.graph.metrics``, paper §II).

The scans run in torch on the device that holds the graph. Every count is an
exact integer (the edge-mass sums are integer-valued float64), and the final
ratios are formed in Python doubles the same way the reference forms them,
so the report equals the reference's bit for bit. A memory-mapped graph is
scanned in row ranges (:func:`~repro_torch.graph.external.iter_row_ranges`),
each range's rows copied to the device once; the ranges' sources are
disjoint, so their unique (vertex, neighbour-partition) pairs add up to the
whole graph's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.external import is_mapped, iter_row_ranges


def _range_counts(p: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, k: int):
    """(cut entries, external (vertex, partition) pairs) of the CSR entries
    ``src -> dst``, both on the device."""
    pd = p[dst]
    cut = int((p[src] != pd).sum())
    uniq = torch.unique(src * k + pd)
    external = int((uniq % k != p[uniq // k]).sum())
    return cut, external


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
    n = max(graph.num_vertices, 1)
    if is_mapped(graph):
        p = torch.from_numpy(part.astype(np.int64)).to(device)
        e_counts = torch.zeros(k, dtype=torch.float64, device=p.device)
        cut = external = 0
        for lo, degs, dst in iter_row_ranges(graph):
            degs_d = torch.from_numpy(degs).to(p.device)
            rows = torch.arange(lo, lo + degs.shape[0], dtype=torch.int64, device=p.device)
            src = torch.repeat_interleave(rows, degs_d, output_size=dst.shape[0])
            c, x = _range_counts(p, src, torch.from_numpy(dst).to(p.device).long(), k)
            cut += c
            external += x
            e_counts.index_add_(0, p[rows], degs_d.to(torch.float64))
    else:
        g = graph.to(device)
        p = torch.from_numpy(part.astype(np.int64)).to(g.device)
        # communication volume: unique (u, neighbour-partition) pairs outside
        # u's own partition
        cut, external = _range_counts(p, g.sources(), g.indices.long(), k)
        e_counts = torch.zeros(k, dtype=torch.float64, device=g.device)
        e_counts.index_add_(0, p, g.degrees().to(torch.float64))
    v_counts = torch.bincount(p, minlength=k)
    return {
        "k": k,
        # edge-cut: symmetric storage counts every cut edge twice
        "edge_cut": (cut // 2) / max(graph.num_edges, 1),
        "comm_volume": external / (k * n),
        "vertex_imbalance": _imbalance(v_counts, k),
        "edge_imbalance": _imbalance(e_counts, k),
    }


def _imbalance(counts: torch.Tensor, k: int) -> float:
    # max over mean; the sum of integer-valued counts is exact in any order
    mean = float(counts.sum().item()) / k
    return float(np.float64(counts.max().item()) / max(mean, 1e-12))
