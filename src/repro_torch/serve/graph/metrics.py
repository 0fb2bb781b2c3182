"""Serving metrics: per-query records, per-partition load, and the report
(port of ``repro.serve.graph.metrics``; host numpy, the same reductions in
the same order, so every sim float equals the reference's).

Two clocks run through every query:

* **wall** - real elapsed time from arrival to completion on this machine's
  thread pool. Includes genuine queueing and scheduling effects but also the
  noise of the host, so it is reported, never gated.
* **sim** - deterministic network-model time accumulated from the *actual*
  message flow the router produced: ``scanned/edge_scan_rate + rounds * rtt
  + wire_bytes/bandwidth`` with the same :class:`~repro_torch.db.engine.DBCostModel`
  constants the analytic DB study uses. Because RPC rounds and bytes come
  from real routed messages (not the closed-form formula), sim numbers move
  when the partition, the replication plan, or the batching changes - and
  they are bit-reproducible across hosts, so CI can gate on them.

Throughput under closed-loop load is bounded by two resources and the report
exposes both: the client side (``concurrency`` in-flight slots each waiting a
full latency per query -> ``sum(sim_latency)/concurrency``) and the server
side (the busiest partition's busy time - the paper's straggler story).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "MSG_HEADER_BYTES",
    "ID_BYTES",
    "QueryRecord",
    "PartitionLoad",
    "ServingReport",
    "latency_quantiles",
    "latency_histogram",
    "summarize",
]

# wire-format accounting: one batched message costs a header plus its ids
# (requests) or values/adjacency entries (responses)
MSG_HEADER_BYTES = 64
ID_BYTES = 8


@dataclasses.dataclass
class QueryRecord:
    """One completed query, as observed by its master partition."""

    qid: int
    kind: str  # "point" | "one_hop" | "two_hop"
    seed: int
    master: int
    wall_s: float
    sim_s: float
    rounds: int  # batched RPC round trips on the query's critical path
    rpcs: int  # request/response pairs the query shipped
    wire_bytes: int  # request + response bytes across all its messages
    scanned_edges: int  # adjacency entries scanned on its behalf (all workers)
    result: object = None  # int degree (point) or sorted int64 ids (hops)


@dataclasses.dataclass
class PartitionLoad:
    """Counters one partition's worker accumulates; single-writer by design
    (only the thread owning the partition touches them)."""

    queries: int = 0  # queries mastered here
    scanned_edges: int = 0
    remote_entries: int = 0  # payload entries ingested from remote responses
    msgs_in: int = 0
    msgs_out: int = 0
    bytes_in: int = 0
    bytes_out: int = 0

    def busy_s(self, model) -> float:
        """Deterministic busy time under the DB cost model: local scan work,
        the CPU spent deserializing remote payloads (an ingested adjacency
        entry or property value costs like a scanned one - this is where
        cross-partition traffic hurts throughput, the paper's communication-
        volume story), plus this partition's share of the wire."""
        return (
            (self.scanned_edges + self.remote_entries) / model.edge_scan_rate
            + (self.bytes_in + self.bytes_out) / model.bandwidth
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def latency_quantiles(lat_s: np.ndarray) -> dict:
    """p50/p95/p99 + mean/max in milliseconds."""
    if lat_s.size == 0:
        return {k: 0.0 for k in ("p50", "p95", "p99", "mean", "max")}
    q50, q95, q99 = np.quantile(lat_s, (0.50, 0.95, 0.99))
    return {
        "p50": float(q50) * 1e3,
        "p95": float(q95) * 1e3,
        "p99": float(q99) * 1e3,
        "mean": float(lat_s.mean()) * 1e3,
        "max": float(lat_s.max()) * 1e3,
    }


def latency_histogram(lat_s: np.ndarray, buckets: int = 24) -> dict:
    """Log-spaced latency histogram from 1us to 10s (tail-friendly)."""
    edges = np.logspace(-6, 1, buckets + 1)
    counts, _ = np.histogram(lat_s, bins=edges)
    return {
        "edges_ms": (edges * 1e3).tolist(),
        "counts": counts.astype(int).tolist(),
    }


@dataclasses.dataclass
class ServingReport:
    """The load generator's product: throughput, tails, and message flow."""

    mode: str
    num_queries: int
    concurrency: int
    wall_s: float
    qps_wall: float
    sim_client_wall_s: float
    sim_server_wall_s: float
    qps_sim: float
    latency_ms: dict  # {"wall": quantiles, "sim": quantiles}
    histogram: dict  # sim-latency log histogram
    rpcs: int
    messages: int  # physical messages = 2 * rpcs (request + response)
    wire_bytes: int
    scanned_edges: int
    local_queries: int  # queries that completed without any RPC
    kind_counts: dict
    per_partition: list
    replication: dict
    records: list = dataclasses.field(default_factory=list, repr=False)

    def to_dict(self) -> dict:
        d = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "records"
        }
        d["per_partition"] = [p.to_dict() for p in self.per_partition]
        return d

    def answers(self) -> dict:
        """``qid -> result`` for bit-parity checks across configurations."""
        return {r.qid: r.result for r in self.records}


def summarize(
    records: list,
    loads: list,
    wall_s: float,
    concurrency: int,
    model,
    mode: str,
    replication: dict | None = None,
) -> ServingReport:
    records = sorted(records, key=lambda r: r.qid)
    n = len(records)
    sim = np.array([r.sim_s for r in records], dtype=np.float64)
    wall = np.array([r.wall_s for r in records], dtype=np.float64)
    client_wall = float(sim.sum()) / max(int(concurrency), 1)
    server_wall = max((ld.busy_s(model) for ld in loads), default=0.0)
    sim_total = max(client_wall, server_wall)
    return ServingReport(
        mode=mode,
        num_queries=n,
        concurrency=int(concurrency),
        wall_s=wall_s,
        qps_wall=n / wall_s if wall_s > 0 else 0.0,
        sim_client_wall_s=client_wall,
        sim_server_wall_s=server_wall,
        qps_sim=n / sim_total if sim_total > 0 else 0.0,
        latency_ms={
            "wall": latency_quantiles(wall),
            "sim": latency_quantiles(sim),
        },
        histogram=latency_histogram(sim),
        rpcs=sum(r.rpcs for r in records),
        messages=2 * sum(r.rpcs for r in records),
        wire_bytes=sum(r.wire_bytes for r in records),
        scanned_edges=sum(r.scanned_edges for r in records),
        local_queries=sum(1 for r in records if r.rpcs == 0),
        kind_counts={
            kind: sum(1 for r in records if r.kind == kind)
            for kind in ("point", "one_hop", "two_hop")
        },
        per_partition=list(loads),
        replication=dict(replication or {}),
        records=records,
    )
