"""Random / hash / range vertex partitioners, the trivial baselines (port
of ``repro.core.random_hash``). Host numpy, as in the reference: they have
no streaming scoring core and launch nothing. ``device`` is accepted and
unused, so every registered callable takes the same keywords."""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph

__all__ = ["partition_random", "partition_hash", "partition_chunked"]


def partition_random(graph: CSRGraph, k: int, seed: int = 0, **_) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=graph.num_vertices, dtype=np.int64).astype(np.int32)


def partition_hash(graph: CSRGraph, k: int, **_) -> np.ndarray:
    # splitmix-style integer hash for a deterministic spread
    v = np.arange(graph.num_vertices, dtype=np.uint64)
    v = (v ^ (v >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    v = (v ^ (v >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    v = v ^ (v >> np.uint64(31))
    return (v % np.uint64(k)).astype(np.int32)


def partition_chunked(graph: CSRGraph, k: int, **_) -> np.ndarray:
    """Contiguous id ranges - strong locality baseline (range partitioning)."""
    n = graph.num_vertices
    bounds = np.linspace(0, n, k + 1).astype(np.int64)
    part = np.zeros(n, dtype=np.int32)
    for i in range(k):
        part[bounds[i] : bounds[i + 1]] = i
    return part
