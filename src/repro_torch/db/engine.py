"""Batched k-hop neighbourhood query engine with distributed cost accounting
(port of ``repro.db.engine``).

Execution model (JanusGraph-style, vertex-partitioned storage):
  * a query for seed ``s`` is routed to the worker owning ``s`` (master);
  * hop 1: the master scans s's adjacency locally; neighbour *properties*
    held by other workers are fetched with one RPC per distinct remote
    partition (message batching, as Cassandra/JanusGraph do);
  * hop 2: adjacency of each frontier vertex lives on its owner, so the
    master issues one RPC per distinct owning partition of the frontier,
    each response carrying that shard of the second frontier.

Per-query latency = cpu(scanned edges) + rtt * rounds + bytes / bandwidth.
Throughput is workers-in-parallel with the busiest worker as the bottleneck
(the paper's edge-imbalance -> straggler story), measured over a query batch.

The engine also *executes* the queries (numpy gathers) so results are real
and testable, not just costed. The per-query loop keeps the reference's
operation order, so every float (latencies, busy times, throughput) equals
the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class QueryStats:
    num_queries: int
    hops: int
    total_scanned_edges: int
    total_rpcs: int
    total_net_values: int  # vertex-sized payload units crossing the network
    per_worker_cpu: np.ndarray  # scanned edges attributed to each worker
    per_worker_net: np.ndarray  # payload units attributed to each worker
    latencies_s: np.ndarray  # per-query latency estimate
    per_worker_busy_s: np.ndarray | None = None  # model-costed busy time

    def throughput_qps(self, concurrency: int = 24) -> float:
        """Closed-loop clients: two independent resources bound throughput.

        The client side has ``concurrency`` in-flight slots, each waiting a
        full latency per query, so it finishes N queries in
        ``sum(latency)/concurrency``. The server side is bounded by the
        busiest worker's busy time (the paper's edge-imbalance straggler
        story). Wall time is the max of the two. The serving layer
        (:mod:`repro_torch.serve.graph`) measures the same two bounds from
        real message flow.
        """
        if self.num_queries == 0:
            return 0.0
        client_wall = float(self.latencies_s.sum()) / max(int(concurrency), 1)
        busy = self.per_worker_busy_s
        if busy is None:
            # stats built without the cost model: reconstruct from defaults
            m = DBCostModel()
            busy = (
                self.per_worker_cpu / m.edge_scan_rate
                + self.per_worker_net * m.value_bytes / m.bandwidth
            )
        server_wall = float(np.max(busy)) if len(busy) else 0.0
        wall = max(client_wall, server_wall)
        if wall <= 0:
            return float("inf")
        return self.num_queries / wall

    def p99_latency_s(self) -> float:
        return float(np.quantile(self.latencies_s, 0.99))


@dataclasses.dataclass(frozen=True)
class DBCostModel:
    edge_scan_rate: float = 5.0e7  # adjacency entries/s per worker
    rtt_s: float = 2.0e-4  # one batched RPC round trip
    bandwidth: float = 1.25e9  # bytes/s per worker (10 GbE-ish)
    value_bytes: float = 64.0  # property payload per vertex


class QueryEngine:
    def __init__(self, graph: CSRGraph, part: np.ndarray, k: int,
                 model: DBCostModel | None = None):
        self.graph = graph
        self.part = np.asarray(part, dtype=np.int64)
        self.k = k
        self.model = model or DBCostModel()

    # ------------------------------------------------------------- execution
    def one_hop(self, seeds: np.ndarray) -> tuple[list[np.ndarray], QueryStats]:
        return self._run(seeds, hops=1)

    def two_hop(self, seeds: np.ndarray, fanout_cap: int = 64):
        return self._run(seeds, hops=2, fanout_cap=fanout_cap)

    def _run(self, seeds: np.ndarray, hops: int, fanout_cap: int = 64):
        g, part, k, m = self.graph, self.part, self.k, self.model
        results: list[np.ndarray] = []
        per_worker_cpu = np.zeros(k, dtype=np.float64)
        per_worker_net = np.zeros(k, dtype=np.float64)
        lat = np.zeros(len(seeds), dtype=np.float64)
        tot_scan = tot_rpc = tot_net = 0
        for qi, s in enumerate(np.asarray(seeds)):
            s = int(s)
            master = int(part[s])
            frontier = g.neighbors(s).astype(np.int64)
            scanned = frontier.shape[0]
            rpcs = 0
            net_values = 0
            # hop-1 property fetches for remote neighbours
            remote_parts = np.unique(part[frontier])
            remote_parts = remote_parts[remote_parts != master]
            rpcs += remote_parts.shape[0]
            net_values += int((part[frontier] != master).sum())
            if hops == 2 and frontier.size:
                cap = frontier[:fanout_cap]
                # adjacency of each frontier vertex is scanned on its owner
                owners = part[cap]
                deg = g.degrees[cap]
                for p in np.unique(owners):
                    sel = owners == p
                    work = int(deg[sel].sum())
                    per_worker_cpu[p] += work
                    scanned += work
                    if p != master:
                        rpcs += 1
                        net_values += work  # second frontier ships back
                second = np.concatenate(
                    [g.neighbors(int(v)) for v in cap]
                ) if cap.size else np.empty(0, dtype=np.int32)
                result = np.unique(np.concatenate([frontier, second.astype(np.int64)]))
            else:
                result = frontier
            per_worker_cpu[master] += frontier.shape[0]
            per_worker_net[master] += net_values
            results.append(result)
            rounds = 1 if hops == 1 else 2
            lat[qi] = (
                scanned / m.edge_scan_rate
                + m.rtt_s * max(rounds if rpcs else 0, 0)
                + net_values * m.value_bytes / m.bandwidth
            )
            tot_scan += scanned
            tot_rpc += rpcs
            tot_net += net_values
        stats = QueryStats(
            num_queries=len(seeds),
            hops=hops,
            total_scanned_edges=tot_scan,
            total_rpcs=tot_rpc,
            total_net_values=tot_net,
            per_worker_cpu=per_worker_cpu,
            per_worker_net=per_worker_net,
            latencies_s=lat,
            per_worker_busy_s=(
                per_worker_cpu / m.edge_scan_rate
                + per_worker_net * m.value_bytes / m.bandwidth
            ),
        )
        return results, stats
