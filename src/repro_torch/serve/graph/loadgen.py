"""Load generator: thousands of concurrent mixed queries against a service
(port of ``repro.serve.graph.loadgen``).

Two arrival disciplines:

* **closed loop** - ``concurrency`` client slots, each submitting its next
  query the moment the previous one completes (the completion callback runs
  on the worker thread that finished the query and immediately routes the
  next one, so ``concurrency`` queries are genuinely in flight without a
  thread per client);
* **open loop** - queries arrive on a fixed-rate schedule regardless of
  completions; wall latency is charged from the *scheduled* arrival, so
  queue buildup shows up in the tail instead of being coordinated away.

The workload itself is deterministic given ``seed``: seeds come from the
degree-biased LDBC-like mix (:func:`repro_torch.db.workload.ldbc_query_mix`) and
kinds are drawn from a :class:`QueryMix`. The same ``(qid, kind, seed)``
list is produced for any concurrency/worker count, which is what lets tests
pin bit-identical answers across serving configurations.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from repro_torch.serve.graph.metrics import ServingReport, summarize

__all__ = ["QueryMix", "build_workload", "run_load"]


@dataclasses.dataclass(frozen=True)
class QueryMix:
    """Fractions of each query kind; must sum to 1."""

    point: float = 0.2
    one_hop: float = 0.4
    two_hop: float = 0.4

    def __post_init__(self) -> None:
        fr = (self.point, self.one_hop, self.two_hop)
        if any(f < 0 for f in fr):
            raise ValueError(f"mix fractions must be >= 0, got {fr}")
        if abs(sum(fr) - 1.0) > 1e-6:
            raise ValueError(f"mix fractions must sum to 1, got {sum(fr)}")

    @classmethod
    def parse(cls, text: str) -> "QueryMix":
        """``"point=0.2,one_hop=0.4,two_hop=0.4"`` -> QueryMix."""
        fields = {f.name for f in dataclasses.fields(cls)}
        out = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            if name not in fields:
                raise ValueError(
                    f"unknown mix component {name!r}; expected {sorted(fields)}"
                )
            out[name] = float(val)
        return cls(**out)


def build_workload(
    graph, num_queries: int, mix: QueryMix, seed: int = 0,
    degree_biased: bool = True,
) -> list[tuple[str, int]]:
    """Deterministic ``[(kind, seed_vertex), ...]`` of length num_queries."""
    from repro_torch.db.workload import ldbc_query_mix

    seeds = ldbc_query_mix(
        graph, num_queries, seed=seed, degree_biased=degree_biased
    )
    rng = np.random.default_rng(seed + 0x5EED)
    kinds = rng.choice(
        ("point", "one_hop", "two_hop"),
        size=num_queries,
        p=(mix.point, mix.one_hop, mix.two_hop),
    )
    return [(str(k), int(s)) for k, s in zip(kinds, seeds)]


def run_load(
    service,
    num_queries: int = 1000,
    concurrency: int = 64,
    mix: QueryMix | str | None = None,
    seed: int = 0,
    mode: str = "closed",
    rate_qps: float | None = None,
    workload: list[tuple[str, int]] | None = None,
    degree_biased: bool = True,
) -> ServingReport:
    """Drive ``service`` with a mixed query load and summarize the outcome.

    The service is started/stopped here when it is not already running, so
    ``run_load(result.serve(), ...)`` is a one-liner.
    """
    if isinstance(mix, str):
        mix = QueryMix.parse(mix)
    mix = mix or QueryMix()
    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be 'closed' or 'open', got {mode!r}")
    if workload is None:
        workload = build_workload(
            service.graph, num_queries, mix, seed=seed,
            degree_biased=degree_biased,
        )
    total = len(workload)
    owns_service = not service.running
    if owns_service:
        service.start()
    try:
        if total == 0:
            wall_s, records = 0.0, []
        elif mode == "closed":
            wall_s, records = _closed_loop(service, workload, concurrency)
        else:
            if not rate_qps or rate_qps <= 0:
                raise ValueError("open-loop mode needs rate_qps > 0")
            wall_s, records = _open_loop(service, workload, rate_qps)
        # quiesce before reading the per-partition counters
        if owns_service:
            service.stop()
            owns_service = False
        return summarize(
            records,
            service.loads(),
            wall_s,
            concurrency if mode == "closed" else max(int(concurrency), 1),
            service.model,
            mode,
            replication=service.replication_stats(),
        )
    finally:
        if owns_service:
            service.stop()


def _closed_loop(service, workload, concurrency):
    concurrency = max(int(concurrency), 1)
    pending = deque(enumerate(workload))
    records: list = []
    lock = threading.Lock()
    done = threading.Event()
    total = len(workload)

    def on_done(rec):
        with lock:
            records.append(rec)
            nxt = pending.popleft() if pending else None
            finished = len(records) == total
        if nxt is not None:
            qid, (kind, vseed) = nxt
            service.submit(kind, vseed, qid=qid, on_done=on_done)
        if finished:
            done.set()

    t0 = time.perf_counter()
    with lock:
        first = [pending.popleft() for _ in range(min(concurrency, total))]
    for qid, (kind, vseed) in first:
        service.submit(kind, vseed, qid=qid, on_done=on_done)
    if not done.wait(timeout=600):  # pragma: no cover - hang guard
        raise RuntimeError(
            f"closed-loop load timed out: {len(records)}/{total} completed"
        )
    return time.perf_counter() - t0, records


def _open_loop(service, workload, rate_qps):
    records: list = []
    lock = threading.Lock()
    done = threading.Event()
    total = len(workload)

    def on_done(rec):
        with lock:
            records.append(rec)
            finished = len(records) == total
        if finished:
            done.set()

    t0 = time.perf_counter()
    gap = 1.0 / float(rate_qps)
    for qid, (kind, vseed) in enumerate(workload):
        arrival = t0 + qid * gap
        now = time.perf_counter()
        if arrival > now:
            time.sleep(arrival - now)
        service.submit(
            kind, vseed, qid=qid, on_done=on_done, arrival_s=arrival
        )
    if not done.wait(timeout=600):  # pragma: no cover - hang guard
        raise RuntimeError(
            f"open-loop load timed out: {len(records)}/{total} completed"
        )
    return time.perf_counter() - t0, records
