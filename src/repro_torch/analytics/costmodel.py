"""Analytic workload cost model (port of ``repro.analytics.costmodel``;
paper Table IV / Fig. 2 analogue).

Modelled per-iteration time =
    max_p(compute_p) + max_p(network_p) + overhead
with
    compute_p = local_edges_p / edge_rate        (all programs iterate edges)
    network_p = (sent_p + recv_p) * msg_bytes / bandwidth

Edge-cut (vertex-partitioned) engines with sender-side aggregation send each
vertex once per remote partition containing a neighbour (Σ_u D(u) messages -
the paper's communication volume). Vertex-cut (edge-partitioned) engines
(HDRF/Ginger) sync each replicated vertex mirror->master and back:
2 * (|A(v)| - 1) messages per vertex per iteration.

:class:`CostModel`'s defaults are the reference's model parameters, kept
unchanged so that ``mode="model"`` gives the reference's numbers. They are
parameters of a model, not a measurement of any device, this card included:
a time from :func:`workload_cost` is modelled, never measured.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hdrf import EdgePartition
from repro_torch.graph.csr import CSRGraph

__all__ = ["CostModel", "workload_cost"]


@dataclasses.dataclass(frozen=True)
class CostModel:
    edge_rate: float = 2.0e10  # edges/s processed per worker
    bandwidth: float = 50.0e9  # bytes/s per worker interconnect
    msg_bytes: float = 8.0  # payload per halo message (id + value)
    per_iter_overhead_s: float = 1e-4  # barrier/launch overhead


def _edge_cut_traffic(graph: CSRGraph, part: np.ndarray, k: int):
    """Per-worker sent/received message counts (sender-side aggregation)."""
    src = np.repeat(np.arange(graph.num_vertices, dtype=np.int64), graph.degrees)
    dst = graph.indices.astype(np.int64)
    pd = part[dst].astype(np.int64)
    key = src * np.int64(k) + pd
    uniq = np.unique(key)
    u = uniq // k
    p = uniq % k
    ext = p != part[u]
    sent = np.bincount(part[u][ext], minlength=k).astype(np.float64)
    recv = np.bincount(p[ext], minlength=k).astype(np.float64)
    return sent, recv


def workload_cost(
    graph: CSRGraph,
    assignment,
    k: int,
    iters: int,
    model: CostModel | None = None,
) -> dict:
    """``assignment`` is either a vertex partition array (edge-cut engines)
    or an :class:`~repro_torch.core.hdrf.EdgePartition` (vertex-cut
    engines)."""
    model = model or CostModel()
    if isinstance(assignment, EdgePartition):
        edges_per_worker = assignment.edge_counts.astype(np.float64)
        reps = assignment.replicas.sum(axis=1).astype(np.float64)
        # mirrors -> master partial aggregates, then master -> mirrors values
        v_msgs = 2.0 * np.maximum(reps - 1.0, 0.0)
        # attribute send/recv to the master's partition (upper bound on the
        # hot worker; mirrors' traffic is spread across their partitions)
        sent = np.bincount(
            assignment.masters, weights=v_msgs, minlength=k
        ).astype(np.float64)
        recv = sent.copy()
    else:
        part = np.asarray(assignment)
        if part.shape != (graph.num_vertices,):
            raise ValueError(
                f"assignment has shape {part.shape}, expected "
                f"({graph.num_vertices},): a vertex partition array"
            )
        deg = graph.degrees.astype(np.float64)
        edges_per_worker = np.bincount(part, weights=deg, minlength=k)
        sent, recv = _edge_cut_traffic(graph, part, k)

    compute_s = edges_per_worker.max() / model.edge_rate
    network_s = (sent + recv).max() * model.msg_bytes / model.bandwidth
    per_iter = compute_s + network_s + model.per_iter_overhead_s
    return {
        "iters": iters,
        "compute_s_per_iter": compute_s,
        "network_s_per_iter": network_s,
        "total_s": per_iter * iters,
        "straggler_ratio": float(
            edges_per_worker.max() / max(edges_per_worker.mean(), 1e-12)
        ),
        "total_messages_per_iter": float(sent.sum()),
        "network_bytes_per_iter": float(sent.sum() * model.msg_bytes),
    }
