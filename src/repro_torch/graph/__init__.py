"""Graph structure, on-disk graphs, seeded generators, stream orders and
quality metrics."""
from repro_torch.graph.churn import ChurnStream, churn_from_graph, rmat_churn
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
from repro_torch.graph.metrics import (
    check_balance,
    communication_volume,
    edge_cut,
    edge_imbalance,
    partition_edge_counts,
    partition_vertex_counts,
    quality_report,
    vertex_imbalance,
)
from repro_torch.graph.stream import ShardedStream, stream_order, vertex_stream

__all__ = [
    "CSRGraph",
    "ChurnStream",
    "churn_from_graph",
    "rmat_churn",
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
    "edge_cut",
    "communication_volume",
    "partition_vertex_counts",
    "partition_edge_counts",
    "vertex_imbalance",
    "edge_imbalance",
    "quality_report",
    "check_balance",
    "ShardedStream",
    "stream_order",
    "vertex_stream",
]
