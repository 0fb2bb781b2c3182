"""Partition-aware graph analytics on the card (port of ``repro.analytics``;
paper §IV-B, Table IV).

A Pregel-style vertex-program engine where vertex->device placement comes
from a partitioner; halo-exchange volume is exactly the paper's
communication-volume metric, and per-device edge counts are its straggler
metric. The K devices are simulated on the leading axis of one card's
arrays (``GraphEngine.run_simulated``) or run as K processes with the halo
over ``torch.distributed`` (``GraphEngine.run_sharded``); the gather/reduce
of every iteration is one launch of the hand-written ``ell_spmv`` kernel
(a launch a rank in the sharded mode).
"""
from repro_torch.analytics.costmodel import CostModel, workload_cost
from repro_torch.analytics.engine import GraphEngine, RunStats
from repro_torch.analytics.localize import LocalizedGraph, localize
from repro_torch.analytics.programs import PROGRAMS, cc_program, pagerank_program, sssp_program

__all__ = [
    "GraphEngine",
    "RunStats",
    "LocalizedGraph",
    "localize",
    "PROGRAMS",
    "pagerank_program",
    "cc_program",
    "sssp_program",
    "CostModel",
    "workload_cost",
]
