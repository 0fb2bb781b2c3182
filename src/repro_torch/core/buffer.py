"""CUTTANA's prioritized vertex buffer (paper §III-A, Algorithm 1).

Port of ``repro.core.buffer``. A bounded max-priority queue keyed by the
buffer score of a :class:`~repro_torch.core.priority.BufferPriority`
strategy (Eq. 6 by default); score updates push a fresh heap entry and
invalidate the old one by version. Degree / assigned-count / version /
membership live in flat numpy arrays indexed by vertex id, so a placed
vertex's whole neighbourhood is notified in one vectorised call. With
``graph=`` the neighbour lists come from the host CSR; without one
(standalone use, the preserved seed loop) the neighbour arrays passed to
:meth:`PriorityBuffer.push` are kept in a side table. Strategies with
``tracks_parts`` receive partition ids through ``push(..., nbr_parts=)`` /
``notify_many(..., parts=)``. The buffer runs on the host: its order of
evictions is sequential and data-dependent.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.priority import BufferPriority, Eq6Priority


class PriorityBuffer:
    def __init__(
        self,
        capacity: int,
        d_max: int | None = None,
        theta: float = 1.0,
        graph=None,
        priority: BufferPriority | None = None,
    ):
        if priority is None:
            priority = Eq6Priority(1 if d_max is None else d_max, theta)
        self.capacity = int(capacity)
        self.priority = priority
        self.d_max = priority.d_max
        self.theta = priority.theta
        self._heap: list[tuple[float, int, int]] = []  # (-score, v, version)
        self._size = 0
        if graph is not None:
            self._indptr = graph.indptr
            self._indices = graph.indices
            self._nbrs = None
            n = graph.num_vertices
            self._deg = np.asarray(graph.degrees, dtype=np.int64)
        else:
            self._indptr = None
            self._indices = None
            self._nbrs: dict[int, np.ndarray] = {}
            n = 0
            self._deg = np.zeros(0, dtype=np.int64)
        self._assigned = np.zeros(n, dtype=np.int64)
        self._version = np.zeros(n, dtype=np.int64)
        self._in = np.zeros(n, dtype=bool)

    def __len__(self) -> int:
        return self._size

    @property
    def full(self) -> bool:
        return self._size >= self.capacity

    # ------------------------------------------------------------- internals
    def _grow(self, hi: int) -> None:
        cur = self._in.shape[0]
        if hi <= cur:
            return
        new = max(hi, 2 * cur, 64)
        for name in ("_deg", "_assigned", "_version"):
            old = getattr(self, name)
            arr = np.zeros(new, dtype=old.dtype)
            arr[:cur] = old
            setattr(self, name, arr)
        arr = np.zeros(new, dtype=bool)
        arr[:cur] = self._in
        self._in = arr

    def _neighbors(self, v: int) -> np.ndarray:
        if self._indptr is not None:
            return self._indices[self._indptr[v] : self._indptr[v + 1]]
        return self._nbrs[v]

    def score(self, v: int) -> float:
        deg = int(self._deg[v])
        return self.priority.score_counts(v, deg, int(self._assigned[v]))

    # ------------------------------------------------------------------ ops
    def push(
        self,
        v: int,
        nbrs: np.ndarray | None = None,
        assigned_count: int = 0,
        nbr_parts: np.ndarray | None = None,
    ) -> None:
        v = int(v)
        if self.contains(v):
            raise ValueError(f"vertex {v} is already buffered")
        self._grow(v + 1)
        if self._indptr is None:
            if nbrs is None:
                raise ValueError("a buffer without a graph needs nbrs")
            self._nbrs[v] = nbrs
            self._deg[v] = nbrs.shape[0]
        self._in[v] = True
        self._assigned[v] = int(assigned_count)
        if self.priority.tracks_parts:
            self.priority.on_push(v, nbr_parts)
        heapq.heappush(self._heap, (-self.score(v), v, int(self._version[v])))
        self._size += 1

    def contains(self, v: int) -> bool:
        return v < self._in.shape[0] and bool(self._in[v])

    def notify_assigned(self, v: int) -> bool:
        """A neighbour of buffered ``v`` was placed. Returns True if ``v`` is
        now *complete* (all neighbours assigned) and should be evicted now."""
        self._assigned[v] += 1
        if self._assigned[v] >= self._deg[v]:
            return True
        self._version[v] += 1
        heapq.heappush(self._heap, (-self.score(v), v, int(self._version[v])))
        return False

    def notify_many(self, vs: np.ndarray, parts=None) -> list[int]:
        """Bump every buffered vertex in ``vs`` once per occurrence (a placed
        vertex's whole neighbourhood; duplicates come from multi-edge
        graphs); returns the now-complete ones in first-occurrence order
        WITHOUT removing them (the caller cascades). ``parts`` - the
        partition of the newly assigned neighbour, scalar or aligned with
        ``vs`` - feeds partition-tracking strategies."""
        if self._size == 0 or vs.size == 0 or self._in.shape[0] == 0:
            return []
        track = parts is not None and self.priority.tracks_parts
        parts_arr = None
        if track and not (np.isscalar(parts) or getattr(parts, "ndim", 1) == 0):
            parts_arr = np.asarray(parts)
        keep = vs < self._in.shape[0]
        vs = vs[keep]
        if parts_arr is not None:
            parts_arr = parts_arr[keep]
        inmask = self._in[vs]
        buffered = vs[inmask]
        if buffered.size == 0:
            return []
        np.add.at(self._assigned, buffered, 1)
        if track:
            self.priority.on_notify(
                buffered, parts if parts_arr is None else parts_arr[inmask]
            )
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
        if not self.contains(v):
            raise ValueError(f"vertex {v} is not buffered")
        nbrs = self._neighbors(v)
        if self._indptr is None:
            del self._nbrs[v]
        self._in[v] = False
        self._version[v] += 1
        self._size -= 1
        if self.priority.tracks_parts:
            self.priority.on_remove(v)
        return nbrs

    def pop_best(self) -> tuple[int, np.ndarray]:
        """Pop the vertex with the highest buffer score."""
        while self._heap:
            _, v, ver = heapq.heappop(self._heap)
            if self._in[v] and self._version[v] == ver:
                return v, self.remove(v)
        raise IndexError("pop from empty buffer")
