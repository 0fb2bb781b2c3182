"""LDBC-SNB-interactive-like query mix: seeds biased to active users
(degree-proportional, as person-centric SNB reads are). Port of
``repro.db.workload``: the same ``default_rng(seed)`` draws."""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def ldbc_query_mix(
    graph: CSRGraph, num_queries: int, seed: int = 0, degree_biased: bool = True
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if not degree_biased:
        return rng.integers(0, graph.num_vertices, size=num_queries)
    deg = graph.degrees.astype(np.float64)
    p = deg / deg.sum()
    return rng.choice(graph.num_vertices, size=num_queries, p=p)
