"""Graph structure, seeded generators, stream orders and quality metrics."""
from repro_torch.graph.csr import CSRGraph, DeviceCSR
from repro_torch.graph.generators import (
    DATASETS,
    ldbc_like_graph,
    load_dataset,
    powerlaw_cluster_graph,
    rmat_graph,
    road_graph,
)
from repro_torch.graph.metrics import quality_report
from repro_torch.graph.stream import ShardedStream, stream_order

__all__ = [
    "CSRGraph",
    "DeviceCSR",
    "DATASETS",
    "ldbc_like_graph",
    "load_dataset",
    "powerlaw_cluster_graph",
    "rmat_graph",
    "road_graph",
    "quality_report",
    "ShardedStream",
    "stream_order",
]
