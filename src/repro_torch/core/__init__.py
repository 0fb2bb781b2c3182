"""Streaming partitioners: shared state, the engine, and the zoo the
registry (:mod:`repro_torch.api.registry`) names (port of ``repro.core``).

The canonical entry point is :mod:`repro_torch.api` - build a
:class:`~repro_torch.api.PartitionSpec` and call
:func:`repro_torch.api.partition` to get a uniform
:class:`~repro_torch.api.PartitionResult` for any registered algorithm.
``PARTITIONERS`` / ``EDGE_PARTITIONERS`` and ``get_partitioner`` /
``get_edge_partitioner`` below are the reference's deprecated shims, views
of the port's registry: each callable is the registered one and takes
``device`` as the registry's callables do.
"""
from __future__ import annotations

from repro_torch.api.registry import REGISTRY, get_info
from repro_torch.core import cuttana, fennel, heistream_like, ldg, legacy
from repro_torch.core.base import FennelParams
from repro_torch.core.cuttana import CuttanaResult, refine_any
from repro_torch.core.cuttana_batched import partition_batched
from repro_torch.core.engine import (
    BufferedPolicy,
    EngineConfig,
    FennelScorer,
    ImmediatePolicy,
    LDGScorer,
    PlacementPolicy,
    Scorer,
    ShardedBufferedPolicy,
    ShardedImmediatePolicy,
    StreamEngine,
)
from repro_torch.core.hdrf import EdgePartition, partition_ginger, partition_hdrf
from repro_torch.core.incremental import (
    IncrementalPartitioner,
    partition_incremental,
    update,
)
from repro_torch.core.parallel import fennel_parallel, partition_parallel
from repro_torch.core.random_hash import partition_chunked, partition_hash, partition_random

# Legacy name -> callable views of the declarative registry (deprecated;
# prefer repro_torch.api). Resolved eagerly so iteration keeps working.
PARTITIONERS = {
    name: info.resolve()
    for name, info in REGISTRY.items()
    if info.kind == "edge-cut"
}

EDGE_PARTITIONERS = {
    name: info.resolve()
    for name, info in REGISTRY.items()
    if info.kind == "vertex-cut"
}


def get_partitioner(name: str):
    """Deprecated shim over :func:`repro_torch.api.get_info`: returns the
    bare callable for an edge-cut (vertex) partitioner. Unknown names raise a
    ``ValueError`` listing registered algorithms and the nearest match."""
    return get_info(name, kind="edge-cut").resolve()


def get_edge_partitioner(name: str):
    """Deprecated shim: bare callable for a vertex-cut (edge) partitioner."""
    return get_info(name, kind="vertex-cut").resolve()


__all__ = [
    "PARTITIONERS",
    "EDGE_PARTITIONERS",
    "get_partitioner",
    "get_edge_partitioner",
    "FennelParams",
    "CuttanaResult",
    "EdgePartition",
    "refine_any",
    "StreamEngine",
    "EngineConfig",
    "Scorer",
    "FennelScorer",
    "LDGScorer",
    "PlacementPolicy",
    "ImmediatePolicy",
    "BufferedPolicy",
    "ShardedImmediatePolicy",
    "ShardedBufferedPolicy",
    "partition_parallel",
    "fennel_parallel",
    "IncrementalPartitioner",
    "partition_incremental",
    "update",
]
