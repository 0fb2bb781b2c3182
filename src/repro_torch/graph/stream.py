"""Vertex stream orders and sharded stream cursors (port of
``repro.graph.stream``).

The orders use numpy's ``default_rng(seed)`` exactly as the reference, so a
stream is the same array in both packages. :class:`ShardedStream` splits an
order into ``S`` interleaved shard cursors for the parallel engine (paper
§V): shard ``s`` sees every ``S``-th vertex of the base order.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator

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


def vertex_stream(
    graph: CSRGraph, order: str = "natural", seed: int = 0
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(v, N(v))`` in the stream order ``order``."""
    for v in stream_order(graph, order, seed):
        yield int(v), graph.neighbors(int(v))


@dataclasses.dataclass(frozen=True)
class ShardedStream:
    """``S`` interleaved shard cursors over one base stream order.

    ``shards[s] == ids[s::S]`` - a round-robin split, so every vertex appears
    in exactly one shard and shard lengths differ by at most one. The
    parallel engine advances all cursors in lock step (one *superstep* per
    round) and exchanges assignments only at superstep boundaries.
    """

    num_shards: int
    shards: tuple[np.ndarray, ...]

    @classmethod
    def from_ids(cls, ids: np.ndarray, num_shards: int) -> "ShardedStream":
        s = int(num_shards)
        if s < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        # each cursor contiguous once, so superstep batches sliced from it
        # are contiguous too
        return cls(s, tuple(np.ascontiguousarray(ids[i::s]) for i in range(s)))

    @classmethod
    def from_order(
        cls,
        graph: CSRGraph,
        num_shards: int,
        order: str = "natural",
        seed: int = 0,
    ) -> "ShardedStream":
        return cls.from_ids(stream_order(graph, order, seed), num_shards)

    @property
    def num_vertices(self) -> int:
        return sum(shard.shape[0] for shard in self.shards)

    def shard_of(self, num_vertices: int) -> np.ndarray:
        """Which shard streams each vertex (-1 if the vertex is in no shard -
        only possible with an ``ids`` subset). The dtype is the narrowest
        signed integer that fits ``num_shards``: int8 up to 127 shards,
        int16 up to 32767, int32 beyond."""
        if self.num_shards <= np.iinfo(np.int8).max:
            dtype = np.int8
        elif self.num_shards <= np.iinfo(np.int16).max:
            dtype = np.int16
        else:
            dtype = np.int32
        out = np.full(num_vertices, -1, dtype=dtype)
        for s, shard in enumerate(self.shards):
            out[shard] = s
        return out

    def num_supersteps(self, chunk: int) -> int:
        longest = max((shard.shape[0] for shard in self.shards), default=0)
        return -(-longest // max(int(chunk), 1))

    def superstep_batches(self, chunk: int) -> Iterator[list[np.ndarray]]:
        """One list of per-shard id batches per superstep; exhausted shards
        contribute empty batches until the longest cursor finishes."""
        chunk = max(int(chunk), 1)
        for step in range(self.num_supersteps(chunk)):
            lo = step * chunk
            yield [shard[lo : lo + chunk] for shard in self.shards]
