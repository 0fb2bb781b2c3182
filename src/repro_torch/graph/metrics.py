"""Partition quality metrics (port of ``repro.graph.metrics``, paper §II).

All metrics take the graph and an assignment array ``part`` of shape [|V|]
with values in [0, K). The scans run in torch on ``device``; every count is
an exact integer (the edge-mass sums are integer-valued float64), and the
ratios are formed on the host the way the reference forms them, so each
function equals the reference's bit for bit. A memory-mapped graph is
scanned in row ranges (:func:`~repro_torch.graph.external.iter_row_ranges`),
each range's rows copied to the device once; the ranges' sources are
disjoint, so their unique (vertex, neighbour-partition) pairs add up to the
whole graph's. :func:`quality_report` runs one scan for all four metrics and
forms them with the same helpers as the single functions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.external import is_mapped, iter_row_ranges

__all__ = [
    "edge_cut",
    "communication_volume",
    "partition_vertex_counts",
    "partition_edge_counts",
    "vertex_imbalance",
    "edge_imbalance",
    "quality_report",
    "check_balance",
]


def _entries(graph: CSRGraph, device: torch.device):
    """Yield ``(rows, degs, src, dst)`` on ``device``: the rows' ids and
    degrees and the sources and neighbours of their CSR entries; the whole
    graph at once, or a mapped graph's row ranges one at a time."""
    if is_mapped(graph):
        for lo, degs, dst in iter_row_ranges(graph):
            degs_d = torch.from_numpy(degs).to(device)
            rows = torch.arange(lo, lo + degs.shape[0], dtype=torch.int64, device=device)
            src = torch.repeat_interleave(rows, degs_d, output_size=dst.shape[0])
            yield rows, degs_d, src, torch.from_numpy(dst).to(device).long()
    else:
        g = graph.to(device)
        rows = torch.arange(graph.num_vertices, dtype=torch.int64, device=g.device)
        yield rows, g.degrees(), g.sources(), g.indices.long()


def _part_on(part: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(part).astype(np.int64)).to(resolve_device(device))


def _scan(graph: CSRGraph, part: np.ndarray, k: int, device, *, cut: bool = False,
          external: bool = False, mass: bool = False) -> dict:
    """One pass over the CSR entries: ``cut`` (entries whose ends sit in
    different partitions), ``external`` ((vertex, neighbour-partition) pairs
    outside the vertex's own partition) and ``mass`` (float64[k] degree mass
    on the host), as asked."""
    p = _part_on(part, device)
    out = {"cut": 0, "external": 0}
    e_counts = torch.zeros(k, dtype=torch.float64, device=p.device) if mass else None
    for rows, degs, src, dst in _entries(graph, p.device):
        pd = p[dst]
        if cut:
            out["cut"] += int((p[src] != pd).sum())
        if external:
            uniq = torch.unique(src * k + pd)
            out["external"] += int((uniq % k != p[uniq // k]).sum())
        if mass:
            e_counts.index_add_(0, p[rows], degs.to(torch.float64))
    if mass:
        out["mass"] = e_counts.cpu().numpy()
    return out


def _edge_cut_of(graph: CSRGraph, cut_entries: int) -> float:
    # symmetric storage counts every cut edge twice
    return cut_entries // 2 / max(graph.num_edges, 1)


def _comm_volume_of(graph: CSRGraph, external: int, k: int) -> float:
    return external / (k * max(graph.num_vertices, 1))


def _imbalance(counts: np.ndarray) -> float:
    return float(counts.max() / max(counts.mean(), 1e-12))


def edge_cut(graph: CSRGraph, part: np.ndarray, *, device=None) -> float:
    """Normalized edge-cut  λ_EC  (paper Eq. 3), in [0, 1]."""
    return _edge_cut_of(graph, _scan(graph, part, 1, device, cut=True)["cut"])


def communication_volume(graph: CSRGraph, part: np.ndarray, k: int, *, device=None) -> float:
    """Normalized communication volume  λ_CV  (paper Eq. 4).

    D(u) = number of *other* partitions in which u has a neighbour;
    λ_CV = Σ_u D(u) / (K |V|).
    """
    return _comm_volume_of(graph, _scan(graph, part, k, device, external=True)["external"], k)


def partition_vertex_counts(part: np.ndarray, k: int, *, device=None) -> np.ndarray:
    """int64[k] (or longer, as ``np.bincount``): vertices per partition."""
    return torch.bincount(_part_on(part, device), minlength=k).cpu().numpy()


def partition_edge_counts(graph: CSRGraph, part: np.ndarray, k: int, *, device=None) -> np.ndarray:
    """Σ_{v∈V_i} |N(v)| per partition (degree mass, paper Eq. 2 LHS)."""
    return _scan(graph, part, k, device, mass=True)["mass"]


def vertex_imbalance(part: np.ndarray, k: int, *, device=None) -> float:
    return _imbalance(partition_vertex_counts(part, k, device=device))


def edge_imbalance(graph: CSRGraph, part: np.ndarray, k: int, *, device=None) -> float:
    """max_i Σ_{v∈V_i}|N(v)| over its mean - Fig. 7's straggler metric."""
    return _imbalance(partition_edge_counts(graph, part, k, device=device))


def quality_report(
    graph: CSRGraph, part: np.ndarray, k: int, device: torch.device
) -> dict:
    """λ_EC (Eq. 3), λ_CV (Eq. 4), vertex and edge imbalance of ``part``,
    from one scan."""
    part = np.asarray(part)
    if part.shape != (graph.num_vertices,):
        raise ValueError(
            f"assignment has shape {part.shape}, expected ({graph.num_vertices},)"
        )
    if part.size and (part.min() < 0 or part.max() >= k):
        raise ValueError("invalid partition ids")
    s = _scan(graph, part, k, device, cut=True, external=True, mass=True)
    return {
        "k": k,
        "edge_cut": _edge_cut_of(graph, s["cut"]),
        "comm_volume": _comm_volume_of(graph, s["external"], k),
        "vertex_imbalance": vertex_imbalance(part, k, device=device),
        "edge_imbalance": _imbalance(s["mass"]),
    }


def check_balance(
    sizes: np.ndarray, total: float, k: int, epsilon: float
) -> bool:
    """Balance condition (paper Eq. 1 / Eq. 2): max_i size_i <= (1+eps) total/K."""
    return bool(sizes.max() <= (1.0 + epsilon) * total / k + 1e-9)
