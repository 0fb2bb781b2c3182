"""Vertex stream orders (port of ``repro.graph.stream.stream_order``).

The orders use numpy's ``default_rng(seed)`` exactly as the reference, so a
stream is the same array in both packages. The sharded stream cursors arrive
with the parallel engine.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.graph.csr import CSRGraph


def stream_order(graph: CSRGraph, order: str = "natural", seed: int = 0) -> np.ndarray:
    n = graph.num_vertices
    if order == "natural":
        return np.arange(n, dtype=np.int64)
    if order == "random":
        rng = np.random.default_rng(seed)
        return rng.permutation(n).astype(np.int64)
    if order in ("bfs", "dfs"):
        return _traversal_order(graph, dfs=(order == "dfs"), seed=seed)
    raise ValueError(f"unknown stream order: {order}")


def _traversal_order(graph: CSRGraph, dfs: bool, seed: int) -> np.ndarray:
    n = graph.num_vertices
    rng = np.random.default_rng(seed)
    visited = np.zeros(n, dtype=bool)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    roots = rng.permutation(n)
    for root in roots:
        if visited[root]:
            continue
        stack = deque([int(root)])
        visited[root] = True
        while stack:
            v = stack.pop() if dfs else stack.popleft()
            out[pos] = v
            pos += 1
            for u in graph.neighbors(v):
                if not visited[u]:
                    visited[u] = True
                    stack.append(int(u))
    return out
