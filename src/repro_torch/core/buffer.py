"""CUTTANA's prioritized vertex buffer (paper §III-A, Algorithm 1).

Port of ``repro.core.buffer``. A bounded max-priority queue keyed by the
buffer score (Eq. 6); score updates push a fresh heap entry and invalidate
the old one by version. Degree / assigned-count / version / membership live
in flat numpy arrays indexed by vertex id, so a placed vertex's whole
neighbourhood is notified in one vectorised call. The buffer is read from
the host graph: its order of evictions is sequential and data-dependent.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.priority import Eq6Priority
from repro_torch.graph.csr import CSRGraph


class PriorityBuffer:
    def __init__(self, capacity: int, graph: CSRGraph, priority: Eq6Priority):
        self.capacity = int(capacity)
        self.priority = priority
        self._heap: list[tuple[float, int, int]] = []  # (-score, v, version)
        self._size = 0
        self._indptr = graph.indptr
        self._indices = graph.indices
        n = graph.num_vertices
        self._deg = np.asarray(graph.degrees, dtype=np.int64)
        self._assigned = np.zeros(n, dtype=np.int64)
        self._version = np.zeros(n, dtype=np.int64)
        self._in = np.zeros(n, dtype=bool)

    def __len__(self) -> int:
        return self._size

    @property
    def full(self) -> bool:
        return self._size >= self.capacity

    def score(self, v: int) -> float:
        deg = int(self._deg[v])
        return self.priority.score_counts(v, deg, int(self._assigned[v]))

    # ------------------------------------------------------------------ ops
    def push(self, v: int, assigned_count: int = 0) -> None:
        v = int(v)
        if self._in[v]:
            raise ValueError(f"vertex {v} is already buffered")
        self._in[v] = True
        self._assigned[v] = int(assigned_count)
        heapq.heappush(self._heap, (-self.score(v), v, int(self._version[v])))
        self._size += 1

    def notify_many(self, vs: np.ndarray) -> list[int]:
        """Bump every buffered vertex in ``vs`` once per occurrence (a placed
        vertex's whole neighbourhood); returns the now-complete ones in
        first-occurrence order WITHOUT removing them (the caller cascades)."""
        if self._size == 0 or vs.size == 0:
            return []
        inmask = self._in[vs]
        buffered = vs[inmask]
        if buffered.size == 0:
            return []
        np.add.at(self._assigned, buffered, 1)
        if buffered.size > 1:
            buffered = buffered[np.sort(np.unique(buffered, return_index=True)[1])]
        deg = self._deg[buffered]
        asg = self._assigned[buffered]
        complete = asg >= deg
        live = buffered[~complete]
        if live.size:
            self._version[live] += 1
            sc = self.priority.score_counts_many(
                live, deg[~complete], asg[~complete]
            )
            heap = self._heap
            for s, w, ver in zip(
                (-sc).tolist(), live.tolist(), self._version[live].tolist()
            ):
                heapq.heappush(heap, (s, w, ver))
        return buffered[complete].tolist()

    def remove(self, v: int) -> np.ndarray:
        """Remove ``v``; outstanding heap entries are invalidated by the
        version bump and skipped lazily on pop. Returns its neighbours."""
        v = int(v)
        if not self._in[v]:
            raise ValueError(f"vertex {v} is not buffered")
        self._in[v] = False
        self._version[v] += 1
        self._size -= 1
        return self._indices[self._indptr[v] : self._indptr[v + 1]]

    def pop_best(self) -> tuple[int, np.ndarray]:
        """Pop the vertex with the highest buffer score."""
        while self._heap:
            _, v, ver = heapq.heappop(self._heap)
            if self._in[v] and self._version[v] == ver:
                return v, self.remove(v)
        raise IndexError("pop from empty buffer")
