"""Partition-aware graph serving: router, replication, load gen, metrics
(port of ``repro.serve.graph``).

Turns a partition assignment into a running multi-worker query service and
measures it under production-style load::

    from repro_torch.api import PartitionSpec, partition
    from repro_torch.serve.graph import run_load

    result = partition(graph, PartitionSpec(algo="cuttana", k=8,
                                            balance_mode="edge"))
    report = run_load(result.serve(replication_budget=0.05),
                      num_queries=5000, concurrency=1000)
    print(report.qps_sim, report.latency_ms["sim"]["p99"], report.rpcs)

The partition is made on the card (``device="cuda"``, the default); the
service itself is host numpy and threads over the result's host arrays, as
in the reference, so its answers, counters and sim floats equal the
reference's under the same seed.
"""
from repro_torch.serve.graph.loadgen import QueryMix, build_workload, run_load
from repro_torch.serve.graph.metrics import (
    PartitionLoad,
    QueryRecord,
    ServingReport,
    summarize,
)
from repro_torch.serve.graph.replication import ReplicationPlan, plan_replication
from repro_torch.serve.graph.router import QUERY_KINDS, GraphService

__all__ = [
    "GraphService",
    "QUERY_KINDS",
    "QueryMix",
    "QueryRecord",
    "PartitionLoad",
    "ServingReport",
    "ReplicationPlan",
    "plan_replication",
    "build_workload",
    "run_load",
    "summarize",
]
