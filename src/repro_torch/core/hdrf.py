"""Streaming *edge* partitioners (vertex-cut): HDRF and a Ginger-like
variant (port of ``repro.core.hdrf``).

HDRF (Petroni et al., CIKM'15): for edge (u,v) prefer partitions that already
replicate the endpoints, biased towards replicating the *higher*-degree
endpoint, plus a load-balance term. The Ginger-like variant follows the
PowerLyra hybrid-cut rule (co-locate edges with their low-degree endpoint)
with a FENNEL-shaped balance term.

Each edge's choice reads the replicas and loads the edges before it left, so
both run as the reference's per-edge host loop: they have no streaming
scoring core and launch nothing (``device`` is accepted and unused).
``edge_part`` is indexed by :meth:`~repro_torch.graph.csr.CSRGraph.edges_array`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class EdgePartition:
    edge_part: np.ndarray  # int32[|E|] over graph.edges_array() order
    replicas: np.ndarray  # bool[|V|, k]
    masters: np.ndarray  # int32[|V|] - partition owning the vertex master
    edge_counts: np.ndarray  # int64[k]

    @property
    def replication_factor(self) -> float:
        reps = self.replicas.sum(axis=1)
        return float(reps[reps > 0].mean()) if (reps > 0).any() else 0.0

    def edge_imbalance(self) -> float:
        return float(self.edge_counts.max() / max(self.edge_counts.mean(), 1e-12))


def _partition_edges(
    graph: CSRGraph,
    k: int,
    seed: int,
    mode: str,
    lam: float = 4.0,
    epsilon: float = 0.05,
) -> EdgePartition:
    edges = graph.edges_array()
    m = edges.shape[0]
    # hard edge capacity (PowerGraph-style ingress behaviour): the score's
    # balance term alone cannot beat the replication term on power-law
    # graphs, so production edge partitioners cap partitions outright.
    cap = (1.0 + epsilon) * m / k
    rng = np.random.default_rng(seed)
    order = rng.permutation(m) if mode == "_shuffled" else np.arange(m)
    replicas = np.zeros((graph.num_vertices, k), dtype=bool)
    sizes = np.zeros(k, dtype=np.float64)
    pdeg = np.zeros(graph.num_vertices, dtype=np.int64)  # partial degrees
    edge_part = np.zeros(m, dtype=np.int32)
    # per-vertex per-partition edge counts for master election
    vp_edges = np.zeros((graph.num_vertices, k), dtype=np.int32)
    eps = 1e-3
    # ginger's FENNEL-shaped balance term is stream-invariant - hoist it
    alpha = np.sqrt(k) * m / (max(graph.num_vertices, 1) ** 1.5)
    bal_div = max(m / k, 1)
    for idx in order:
        u, v = int(edges[idx, 0]), int(edges[idx, 1])
        pdeg[u] += 1
        pdeg[v] += 1
        du, dv = pdeg[u], pdeg[v]
        theta_u = du / (du + dv)
        theta_v = 1.0 - theta_u
        if mode == "hdrf":
            gu = np.where(replicas[u], 1.0 + (1.0 - theta_u), 0.0)
            gv = np.where(replicas[v], 1.0 + (1.0 - theta_v), 0.0)
            c_rep = gu + gv
            mx, mn = sizes.max(), sizes.min()
            c_bal = lam * (mx - sizes) / (eps + mx - mn)
            scores = c_rep + c_bal
        else:  # ginger-like hybrid cut
            # favour the partition(s) holding the LOW-degree endpoint
            low_u = du <= dv
            gu = np.where(replicas[u], 2.0 if low_u else 1.0, 0.0)
            gv = np.where(replicas[v], 2.0 if not low_u else 1.0, 0.0)
            scores = gu + gv - alpha * np.sqrt(np.maximum(sizes, 0.0)) / bal_div
        scores = np.where(sizes + 1 > cap, -np.inf, scores)
        p = int(scores.argmax())
        if not np.isfinite(scores[p]):
            # every partition at the hard cap (possible when cap < 1 for tiny
            # graphs): argmax would silently pick partition 0 and break the
            # balance it exists to enforce - fall back to least loaded
            p = int(sizes.argmin())
        edge_part[idx] = p
        replicas[u, p] = True
        replicas[v, p] = True
        sizes[p] += 1
        vp_edges[u, p] += 1
        vp_edges[v, p] += 1
    masters = vp_edges.argmax(axis=1).astype(np.int32)
    # isolated vertices: spread round-robin
    iso = np.flatnonzero(graph.degrees == 0)
    masters[iso] = (iso % k).astype(np.int32)
    return EdgePartition(
        edge_part=edge_part,
        replicas=replicas,
        masters=masters,
        edge_counts=sizes.astype(np.int64),
    )


__all__ = ["EdgePartition", "partition_hdrf", "partition_ginger"]


def partition_hdrf(graph: CSRGraph, k: int, lam: float = 4.0, seed: int = 0, **_) -> EdgePartition:
    return _partition_edges(graph, k, seed, "hdrf", lam)


def partition_ginger(graph: CSRGraph, k: int, seed: int = 0, **_) -> EdgePartition:
    return _partition_edges(graph, k, seed, "ginger")
