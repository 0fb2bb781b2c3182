"""Distributed graph database engine (port of ``repro.db``; paper §IV-B,
Table V).

Batched one/two-hop neighbourhood retrieval over a partitioned graph with
per-worker work and cross-partition RPC accounting - the JanusGraph/LDBC
study's analogue. Host numpy, as in the reference: on the card only the
partition that feeds it runs.
"""
from repro_torch.db.engine import QueryEngine, QueryStats
from repro_torch.db.workload import ldbc_query_mix

__all__ = ["QueryEngine", "QueryStats", "ldbc_query_mix"]
