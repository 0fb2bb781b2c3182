"""Graph structure, on-disk graphs, seeded generators, stream orders and
quality metrics."""
from repro_torch.graph.csr import CSRGraph, DeviceCSR
from repro_torch.graph.external import (
    ExternalCSRGraph,
    convert_csr,
    convert_edge_list,
    load_graph_file,
    load_graph_source,
    validate_source,
    write_external_csr,
)
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
    "ExternalCSRGraph",
    "convert_csr",
    "convert_edge_list",
    "load_graph_file",
    "load_graph_source",
    "validate_source",
    "write_external_csr",
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
