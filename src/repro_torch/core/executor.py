"""Thread-pool execution layer for the sharded superstep engine (port of
``repro.core.executor``).

The superstep core hands each shard a task that touches only (a) immutable
snapshot arrays and (b) that shard's disjoint slice of the superstep output
buffer, so tasks commute: the merged result is independent of scheduling
order and of the worker count. :class:`ShardPool` wraps a
``ThreadPoolExecutor`` with

* deterministic degradation - one worker (or one CPU) executes submissions
  inline on the calling thread, no pool, no queue;
* queue-wait accounting - time between ``submit`` and task start feeds the
  profiler's ``queue_wait_s``;
* ``submit_after`` - FIFO-chained tasks (used for the overlapped
  sub-partition merge: superstep t's merge may run while t+1 scores, but
  merges must apply in superstep order).

``JITTER`` is a test hook: when set to a ``random.Random``, every pooled
task sleeps a few random milliseconds before running. The determinism tests
use it to prove bit-parity is structural (disjoint writes), not an accident
of benign scheduling.

Pool threads run numpy only: every device launch, copy and mirror write of
the port stays on the calling (main) thread, on the current CUDA stream.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

JITTER = None  # test hook: random.Random -> pooled tasks sleep 0..3 ms


def resolve_workers(requested: int | None, num_shards: int) -> int:
    """Worker count for S shard tasks: ``0``/``None`` means auto
    (``min(S, cpu_count)``); explicit requests are clamped to ``[1, S]``
    since a superstep never has more than S concurrent tasks."""
    s = max(int(num_shards), 1)
    if requested is None or int(requested) == 0:
        return max(1, min(s, os.cpu_count() or 1))
    r = int(requested)
    if r < 0:
        raise ValueError(f"max_workers must be >= 0 (0 = auto), got {requested!r}")
    return min(r, s)


class _InlineFuture:
    """Future-shaped wrapper around an already-computed result."""

    __slots__ = ("_value", "_exc")

    def __init__(self, value=None, exc=None):
        self._value = value
        self._exc = exc

    def result(self):
        if self._exc is not None:
            raise self._exc
        return self._value

    def done(self) -> bool:
        return True


class ShardPool:
    """``min(max_workers, S)`` threads for per-shard superstep tasks.

    With one worker every ``submit`` runs inline on the calling thread and
    returns an :class:`_InlineFuture`; the pooled and inline paths execute
    the same task functions on the same inputs, so results are identical by
    construction.
    """

    def __init__(self, requested: int | None, num_shards: int):
        self.workers = resolve_workers(requested, num_shards)
        self.queue_wait_s = 0.0
        self._lock = threading.Lock()
        self._ex: ThreadPoolExecutor | None = (
            ThreadPoolExecutor(self.workers, thread_name_prefix="shard")
            if self.workers > 1
            else None
        )

    def submit(self, fn, *args) -> Future | _InlineFuture:
        if self._ex is None:
            try:
                return _InlineFuture(value=fn(*args))
            except BaseException as exc:  # re-raised at .result()
                return _InlineFuture(exc=exc)
        submitted = time.perf_counter()

        def task():
            wait = time.perf_counter() - submitted
            with self._lock:
                self.queue_wait_s += wait
            if JITTER is not None:
                time.sleep(JITTER.random() * 0.003)
            return fn(*args)

        return self._ex.submit(task)

    def submit_after(self, prev: Future | _InlineFuture | None, fn, *args):
        """Submit a task that runs after ``prev`` completes. The executor
        queue is FIFO, so ``prev`` (submitted earlier) always starts first
        and at worst holds its own worker - never a deadlock."""
        if prev is None:
            return self.submit(fn, *args)

        def chained():
            prev.result()
            return fn(*args)

        return self.submit(chained)

    def shutdown(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=True)
            self._ex = None
