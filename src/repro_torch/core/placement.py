"""CUTTANA-based MoE expert placement (port of ``repro.core.placement``).

Expert-parallel MoE pays one all-to-all per layer: every token travels to the
devices owning its top-k experts. When co-routed experts (experts that often
fire for the SAME token) live on the same device, a token's k probes collapse
into fewer distinct destinations, shrinking hierarchical A2A payload and
DCN hops in multi-pod meshes.

Expert co-activation is a weighted graph: vertices = experts, edge weight
W[e1,e2] = #tokens routing to both. Placing experts on D devices minimizing
cross-device co-activation under a per-device capacity IS balanced graph
partitioning - so we feed it to CUTTANA's refinement engine (the coarse
graph is small: E vertices), exactly the paper's "refinement improves any
partitioner" claim applied to a new domain.

``evaluate_placement`` scores a placement by expected distinct-device fanout
per token (the hierarchical-A2A message count).

Host numpy, as in the reference: the graph has E vertices and the
:class:`Refiner` trades are sequential. Every function gives the
reference's arrays and floats bit for bit (the same ``default_rng`` draws,
the same refiner, the same repair order).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.refinement import Refiner


def coactivation_graph(routing_trace: np.ndarray, n_experts: int) -> np.ndarray:
    """routing_trace: int[T, k] expert ids per token. Returns W[E, E]."""
    w = np.zeros((n_experts, n_experts), dtype=np.float64)
    k = routing_trace.shape[1]
    for a in range(k):
        for b in range(a + 1, k):
            np.add.at(w, (routing_trace[:, a], routing_trace[:, b]), 1.0)
    w = w + w.T
    np.fill_diagonal(w, 0.0)
    return w


def place_experts(
    routing_trace: np.ndarray,
    n_experts: int,
    n_devices: int,
    epsilon: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Returns device_of[E]. Capacity is exact (E/D experts per device) when
    epsilon=0 - expert-parallel kernels need equal expert counts."""
    assert n_experts % n_devices == 0
    w = coactivation_graph(routing_trace, n_experts)
    per_dev = n_experts // n_devices
    init = np.repeat(np.arange(n_devices), per_dev)  # contiguous baseline
    # epsilon=0 would freeze the refiner (no slack to move into); use expert
    # COUNT as the balance mass with one-expert slack, then repair to exact.
    size = np.ones(n_experts)
    r = Refiner(w, init, size, n_devices, epsilon=max(epsilon, 1.0 / per_dev))
    r.refine()
    placement = r.sub_part.copy()
    # repair: enforce exactly per_dev experts per device (move smallest-loss)
    counts = np.bincount(placement, minlength=n_devices)
    while counts.max() > per_dev:
        src = int(counts.argmax())
        dst = int(counts.argmin())
        members = np.flatnonzero(placement == src)
        # move the member with least affinity to src
        internal = w[members][:, members].sum(axis=1)
        victim = members[int(internal.argmin())]
        placement[victim] = dst
        counts[src] -= 1
        counts[dst] += 1
    return placement.astype(np.int32)


def evaluate_placement(
    routing_trace: np.ndarray, placement: np.ndarray
) -> dict:
    """Expected distinct destination devices per token (A2A fanout) and
    device load balance."""
    dev = placement[routing_trace]  # [T, k]
    fanout = np.array([len(np.unique(row)) for row in dev])
    load = np.bincount(dev.reshape(-1), minlength=placement.max() + 1)
    return {
        "mean_fanout": float(fanout.mean()),
        "max_fanout": float(fanout.max()),
        "device_load_imbalance": float(load.max() / max(load.mean(), 1e-12)),
    }


def synthetic_routing_trace(
    n_tokens: int,
    n_experts: int,
    top_k: int,
    n_clusters: int | None = None,
    skew: float = 0.7,
    seed: int = 0,
) -> np.ndarray:
    """Synthetic-but-realistic trace: experts form co-activation clusters
    (domain/language specialisation observed in MoE routing studies); a
    token draws its cluster, then top-k experts mostly within it."""
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(2, n_experts // 8)
    cluster_of = rng.permutation(np.arange(n_experts) % n_clusters)
    members = [np.flatnonzero(cluster_of == c) for c in range(n_clusters)]
    trace = np.zeros((n_tokens, top_k), dtype=np.int64)
    tok_cluster = rng.integers(0, n_clusters, n_tokens)
    for t in range(n_tokens):
        m = members[tok_cluster[t]]
        picks = []
        for _ in range(top_k):
            if rng.random() < skew and m.size:
                picks.append(int(m[rng.integers(m.size)]))
            else:
                picks.append(int(rng.integers(n_experts)))
        trace[t] = picks
    return trace
