"""Async double-buffered prefetch for out-of-core streaming (port of
``repro.graph.prefetch``).

With a compressed mapped graph
(:class:`~repro_torch.graph.external.ExternalCSRGraph` v2), every engine
chunk pays a decode before it can score: disk pages fault in and varint
blocks expand while the card sits idle, then the card scores while the disk
sits idle. In the port the fetch also packs the chunk's rows into the one
host buffer the engine copies to the card. :class:`BatchPrefetcher` overlaps the
two phases - a dedicated thread decodes batch t+1 while the caller scores
batch t, keeping ``depth`` results in flight (double buffering at the
default ``depth=2``).

The prefetcher never reorders or transforms work: the caller supplies a pure
``fetch(item)`` and consumes results strictly in submission order, so the
assignment stream is bit-identical to calling ``fetch`` inline.
:class:`PrefetchStats` counts how often the overlap actually won (the result
was already decoded when the consumer asked - a *hit*) and aggregates decode
and wait wall time for the ``prefetch_hit_rate`` / ``decode_wall_s`` /
``prefetch_wait_s`` telemetry keys.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

__all__ = ["PrefetchStats", "BatchPrefetcher"]


class PrefetchStats:
    """Thread-safe counters for the prefetch pipeline.

    ``hits``/``misses`` count dequeues whose result was/wasn't ready;
    ``decode_wall_s`` is total time spent producing results (on whichever
    thread ran the fetch), ``wait_s`` the time consumers stalled waiting.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.decode_wall_s = 0.0
        self.wait_s = 0.0

    def record_decode(self, seconds: float) -> None:
        with self._lock:
            self.decode_wall_s += seconds

    def record_wait(self, seconds: float, hit: bool) -> None:
        with self._lock:
            self.wait_s += seconds
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def to_telemetry(self) -> dict:
        return {
            "prefetch_hit_rate": round(self.hit_rate, 4),
            "prefetch_wait_s": round(self.wait_s, 6),
            "decode_wall_s": round(self.decode_wall_s, 6),
        }


class BatchPrefetcher:
    """Iterate ``fetch(item)`` results in order, decoding ahead on a thread.

    ``depth`` results are kept in flight on a dedicated single worker (one
    thread suffices: fetches are executed in order, the only goal is
    overlapping them with the consumer). Exceptions from ``fetch`` surface
    at the corresponding ``__next__``; the worker is always shut down, even
    on early exit (``close`` / generator cleanup).
    """

    def __init__(
        self,
        fetch: Callable,
        items: Iterable,
        depth: int = 2,
        stats: PrefetchStats | None = None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._fetch = fetch
        self._items = iter(items)
        self._depth = depth
        self._stats = stats
        self._ex = ThreadPoolExecutor(1, thread_name_prefix="prefetch")
        self._queue: deque = deque()
        self._fill()

    def _timed_fetch(self, item):
        t0 = time.perf_counter()
        try:
            return self._fetch(item)
        finally:
            if self._stats is not None:
                self._stats.record_decode(time.perf_counter() - t0)

    def _fill(self) -> None:
        while len(self._queue) < self._depth:
            try:
                item = next(self._items)
            except StopIteration:
                return
            self._queue.append(self._ex.submit(self._timed_fetch, item))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if not self._queue:
            self.close()
            raise StopIteration
        fut = self._queue.popleft()
        hit = fut.done()
        t0 = time.perf_counter()
        try:
            result = fut.result()
        finally:
            if self._stats is not None:
                self._stats.record_wait(time.perf_counter() - t0, hit)
        self._fill()
        return result

    def close(self) -> None:
        for fut in self._queue:
            fut.cancel()
        self._queue.clear()
        self._ex.shutdown(wait=True)

    def __enter__(self) -> "BatchPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - safety net
        try:
            self.close()
        except Exception:
            pass
