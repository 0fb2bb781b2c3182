"""Partition-aware query service: a router over per-partition workers (port
of ``repro.serve.graph.router``; host numpy and threads, as the reference).

Execution model (one "machine" per partition, JanusGraph-style vertex
partitioning):

* the **router** maps a query's seed vertex to its home partition (the
  *master*) and enqueues it on that partition's worker;
* each **worker** is an event loop owning one or more partitions. It may
  only scan adjacency of vertices its partitions own (or hold replicas of);
  anything else becomes a batched request *message* to the owner's worker;
* a query is a small state machine held at its master: scan the seed's
  adjacency locally, ship one batched property request per distinct remote
  partition of the frontier (hop 1), then - for 2-hop queries - one batched
  adjacency request per distinct remote owner of the capped frontier
  (hop 2). Each batch of concurrent requests is one RPC *round* on the
  query's critical path.

RPC and byte counts are therefore derived from real message flow through
real queues, not from a closed-form formula: the counters move exactly when
a message is put on another worker's inbox. The
:class:`~repro_torch.serve.graph.replication.ReplicationPlan` short-circuits both
request kinds for replicated vertices, which is how ``replication_budget``
buys fewer cross-partition messages without changing any answer.

Threading reuses the :mod:`repro_torch.core.executor` machinery: worker count
resolves via :func:`~repro_torch.core.executor.resolve_workers` (partitions are
striped over threads, each partition's state touched by exactly one
thread), the loops are hosted on a :class:`~repro_torch.core.executor.ShardPool`,
and the ``executor.JITTER`` test hook injects random per-message sleeps so
tests can prove answers are scheduling-independent. ``max_workers=1``
degrades to a deterministic synchronous drain on the calling thread - no
threads, same message flow, same counters.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from queue import Queue

import numpy as np

from repro_torch.core import executor
from repro_torch.db.engine import DBCostModel
from repro_torch.serve.graph.metrics import (
    ID_BYTES,
    MSG_HEADER_BYTES,
    PartitionLoad,
    QueryRecord,
)
from repro_torch.serve.graph.replication import ReplicationPlan, plan_replication

__all__ = ["GraphService", "QUERY_KINDS"]

QUERY_KINDS = ("point", "one_hop", "two_hop")

_STOP = object()


class _Query:
    """In-flight query state, owned by its master partition's thread."""

    __slots__ = (
        "qid", "kind", "seed", "master", "on_done", "arrival",
        "frontier", "parts", "pending", "phase", "rounds", "rpcs",
        "wire_bytes", "scanned", "remote_entries", "result",
    )

    def __init__(self, qid, kind, seed, master, on_done, arrival):
        self.qid = qid
        self.kind = kind
        self.seed = seed
        self.master = master
        self.on_done = on_done
        self.arrival = arrival
        self.frontier = None
        self.parts = []
        self.pending = 0
        self.phase = "start"
        self.rounds = 0
        self.rpcs = 0
        self.wire_bytes = 0
        self.scanned = 0
        self.remote_entries = 0
        self.result = None


class GraphService:
    """A running (or startable) partition-aware query service.

    Usage::

        with result.serve(max_workers=4) as svc:
            report = run_load(svc, num_queries=5000, concurrency=1000)

    ``store_results=False`` keeps only per-query counters (for large load
    runs); answers are then unavailable for bit-parity checks.
    """

    def __init__(
        self,
        graph,
        assignment,
        k: int,
        *,
        replication_budget: float = 0.0,
        max_workers: int = 0,
        cost_model: DBCostModel | None = None,
        fanout_cap: int = 64,
        store_results: bool = True,
    ):
        assignment = np.asarray(assignment, dtype=np.int64)
        if assignment.shape[0] != graph.num_vertices:
            raise ValueError(
                f"assignment covers {assignment.shape[0]} vertices, graph "
                f"has {graph.num_vertices}"
            )
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if assignment.size and int(assignment.max()) >= k:
            raise ValueError("assignment references partitions >= k")
        self.graph = graph
        self.assignment = assignment
        self.k = int(k)
        self.model = cost_model or DBCostModel()
        self.fanout_cap = int(fanout_cap)
        self.store_results = bool(store_results)
        self.workers = executor.resolve_workers(max_workers, k)
        self.plan: ReplicationPlan = plan_replication(
            graph, assignment, k, replication_budget
        )
        # per-partition replica lookup: sorted id array (membership test) +
        # the mirrored adjacency rows (scans must not touch the owner)
        self._replica_ids = [self.plan.replicas_into(p) for p in range(k)]
        self._replica_adj = [
            {int(v): graph.neighbors(int(v)) for v in ids}
            for ids in self._replica_ids
        ]
        self._loads = [PartitionLoad() for _ in range(k)]
        self._states: list[dict[int, _Query]] = [{} for _ in range(k)]
        self._records: list[list[QueryRecord]] = [[] for _ in range(k)]
        self._qid = itertools.count()
        self._running = False
        self._pool = None
        self._futures = []
        self._inboxes = []
        self._sync_queue: deque | None = None
        self._draining = False

    # ---------------------------------------------------------------- lifecycle
    @property
    def running(self) -> bool:
        return self._running

    def start(self) -> "GraphService":
        if self._running:
            return self
        if self.workers == 1:
            self._sync_queue = deque()
        else:
            self._inboxes = [Queue() for _ in range(self.workers)]
            self._pool = executor.ShardPool(self.workers, self.workers)
            self._futures = [
                self._pool.submit(self._loop, t) for t in range(self.workers)
            ]
        self._running = True
        return self

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        if self._pool is not None:
            for inbox in self._inboxes:
                inbox.put(_STOP)
            for fut in self._futures:
                fut.result()  # surfaces worker exceptions
            self._pool.shutdown()
            self._pool = None
            self._futures = []
            self._inboxes = []
        self._sync_queue = None

    def __enter__(self) -> "GraphService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ routing
    def submit(self, kind: str, seed: int, *, qid: int | None = None,
               on_done=None, arrival_s: float | None = None) -> int:
        """Route one query to its home partition. Returns the query id.

        ``arrival_s`` (a ``perf_counter`` timestamp) lets open-loop load
        generators charge queue wait from the *scheduled* arrival, avoiding
        coordinated omission.
        """
        if not self._running:
            raise RuntimeError("service is not running; call start() first")
        if kind not in QUERY_KINDS:
            raise ValueError(
                f"unknown query kind {kind!r}; expected one of {QUERY_KINDS}"
            )
        seed = int(seed)
        if not 0 <= seed < self.graph.num_vertices:
            raise ValueError(f"seed vertex {seed} out of range")
        if qid is None:
            qid = next(self._qid)
        master = int(self.assignment[seed])
        arrival = time.perf_counter() if arrival_s is None else arrival_s
        q = _Query(qid, kind, seed, master, on_done, arrival)
        self._send(master, ("new", q))
        return qid

    def _send(self, dest_partition: int, msg) -> None:
        if self._sync_queue is not None:
            self._sync_queue.append(msg)
            if not self._draining:
                self._draining = True
                try:
                    while self._sync_queue:
                        self._dispatch(self._sync_queue.popleft())
                finally:
                    self._draining = False
        else:
            self._inboxes[dest_partition % self.workers].put(msg)

    def _loop(self, t: int) -> None:
        inbox = self._inboxes[t]
        while True:
            msg = inbox.get()
            if msg is _STOP:
                return
            if executor.JITTER is not None:
                time.sleep(executor.JITTER.random() * 0.003)
            self._dispatch(msg)

    # ----------------------------------------------------------- state machine
    def _dispatch(self, msg) -> None:
        tag = msg[0]
        if tag == "new":
            self._on_new(msg[1])
        elif tag == "req":
            self._on_req(*msg[1])
        elif tag == "resp":
            self._on_resp(*msg[1])
        else:  # pragma: no cover - routing bug
            raise RuntimeError(f"unknown message tag {tag!r}")

    def _is_replica(self, p: int, v: int) -> bool:
        ids = self._replica_ids[p]
        if ids.size == 0:
            return False
        i = np.searchsorted(ids, v)
        return i < ids.size and ids[i] == v

    def _on_new(self, q: _Query) -> None:
        p = q.master
        self._states[p][q.qid] = q
        self._loads[p].queries += 1
        if q.kind == "point":
            # the seed's record lives on its master: fully local
            q.result = int(self.graph.degree(q.seed))
            self._finish(q)
            return
        frontier = self.graph.neighbors(q.seed)
        q.frontier = frontier
        n_scan = int(frontier.shape[0])
        q.scanned += n_scan
        self._loads[p].scanned_edges += n_scan
        # hop-1 property fetch for remote, non-replicated neighbours
        owners = self.assignment[frontier]
        remote = frontier[owners != p]
        if remote.size and self._replica_ids[p].size:
            remote = remote[~np.isin(remote, self._replica_ids[p])]
        if remote.size:
            q.phase = "props"
            q.rounds += 1
            self._ship_requests(q, "props", remote)
        else:
            self._after_props(q)

    def _ship_requests(self, q: _Query, rkind: str, vertices: np.ndarray) -> None:
        """One batched request per distinct owning partition - each put on a
        real inbox and counted as it crosses."""
        owners = self.assignment[vertices]
        dests = np.unique(owners)
        q.pending = int(dests.shape[0])
        p = q.master
        for d in dests:
            ids = vertices[owners == d].astype(np.int64)
            req_bytes = MSG_HEADER_BYTES + ID_BYTES * int(ids.shape[0])
            q.rpcs += 1
            q.wire_bytes += req_bytes
            self._loads[p].msgs_out += 1
            self._loads[p].bytes_out += req_bytes
            self._send(int(d), ("req", (int(d), p, q.qid, rkind, ids)))

    def _on_req(self, dest: int, master: int, qid: int, rkind: str,
                ids: np.ndarray) -> None:
        ld = self._loads[dest]
        req_bytes = MSG_HEADER_BYTES + ID_BYTES * int(ids.shape[0])
        ld.msgs_in += 1
        ld.bytes_in += req_bytes
        if rkind == "props":
            # property read per id: a value-sized payload ships back
            scanned = 0
            entries = int(ids.shape[0])
            arrs = None
            resp_bytes = MSG_HEADER_BYTES + int(
                ids.shape[0] * self.model.value_bytes
            )
        else:  # "adj": scan each id's adjacency here, ship the rows back
            arrs = [self.graph.neighbors(int(v)) for v in ids]
            scanned = int(sum(a.shape[0] for a in arrs))
            entries = scanned
            ld.scanned_edges += scanned
            resp_bytes = MSG_HEADER_BYTES + ID_BYTES * scanned
        ld.msgs_out += 1
        ld.bytes_out += resp_bytes
        self._send(master, ("resp", (master, qid, rkind, scanned, entries,
                                     resp_bytes, arrs)))

    def _on_resp(self, master: int, qid: int, rkind: str, scanned: int,
                 entries: int, resp_bytes: int, arrs) -> None:
        ld = self._loads[master]
        ld.msgs_in += 1
        ld.bytes_in += resp_bytes
        # the master pays CPU to deserialize what it asked for
        ld.remote_entries += entries
        q = self._states[master][qid]
        q.scanned += scanned
        q.remote_entries += entries
        q.wire_bytes += resp_bytes
        if arrs is not None:
            q.parts.extend(arrs)
        q.pending -= 1
        if q.pending:
            return
        if q.phase == "props":
            self._after_props(q)
        else:
            self._finalize_two_hop(q)

    def _after_props(self, q: _Query) -> None:
        if q.kind == "one_hop":
            q.result = q.frontier.astype(np.int64)
            self._finish(q)
            return
        # two_hop: scan the capped frontier's adjacency - locally for owned
        # or replicated vertices, one batched RPC per remaining owner
        p = q.master
        cap = q.frontier[: self.fanout_cap]
        if cap.size == 0:
            self._finalize_two_hop(q)
            return
        owners = self.assignment[cap]
        local_mask = owners == p
        if self._replica_ids[p].size:
            local_mask |= np.isin(cap, self._replica_ids[p])
        n_local_scan = 0
        for v in cap[local_mask]:
            v = int(v)
            row = (
                self.graph.neighbors(v)
                if self.assignment[v] == p
                else self._replica_adj[p][v]
            )
            q.parts.append(row)
            n_local_scan += int(row.shape[0])
        q.scanned += n_local_scan
        self._loads[p].scanned_edges += n_local_scan
        remote = cap[~local_mask]
        if remote.size:
            q.phase = "adj"
            q.rounds += 1
            self._ship_requests(q, "adj", remote)
        else:
            self._finalize_two_hop(q)

    def _finalize_two_hop(self, q: _Query) -> None:
        second = (
            np.concatenate([a.astype(np.int64) for a in q.parts])
            if q.parts
            else np.empty(0, dtype=np.int64)
        )
        q.result = np.unique(
            np.concatenate([q.frontier.astype(np.int64), second])
        )
        self._finish(q)

    def _finish(self, q: _Query) -> None:
        p = q.master
        self._states[p].pop(q.qid, None)
        m = self.model
        sim_s = (
            (q.scanned + q.remote_entries) / m.edge_scan_rate
            + q.rounds * m.rtt_s
            + q.wire_bytes / m.bandwidth
        )
        rec = QueryRecord(
            qid=q.qid,
            kind=q.kind,
            seed=q.seed,
            master=p,
            wall_s=time.perf_counter() - q.arrival,
            sim_s=sim_s,
            rounds=q.rounds,
            rpcs=q.rpcs,
            wire_bytes=q.wire_bytes,
            scanned_edges=q.scanned,
            result=q.result if self.store_results else None,
        )
        self._records[p].append(rec)
        if q.on_done is not None:
            q.on_done(rec)

    # ----------------------------------------------------------------- results
    def loads(self) -> list:
        """Per-partition load counters (read after the service quiesces)."""
        return self._loads

    def drain_records(self) -> list:
        """All completed query records, sorted by qid (read after stop())."""
        out = [r for per_p in self._records for r in per_p]
        out.sort(key=lambda r: r.qid)
        return out

    def replication_stats(self) -> dict:
        return self.plan.stats()
