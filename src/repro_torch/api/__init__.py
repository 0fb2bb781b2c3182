"""``repro_torch.api`` - the typed entry point of the port:

    >>> from repro_torch.api import PartitionSpec, partition
    >>> result = partition(PartitionSpec(algo="cuttana", k=8,
    ...                                  source="dataset:web-s"), device="cuda")
    >>> result.quality()

Every algorithm of the reference's registry is registered
(``list_algorithms()``; ``list_algorithms("vertex-cut")`` for HDRF and
Ginger, whose results carry an ``edge_partition``).
"""
from repro_torch.api.registry import (
    REGISTRY,
    PartitionerInfo,
    get_info,
    list_algorithms,
    register,
)
from repro_torch.api.result import PartitionResult
from repro_torch.api.runner import partition
from repro_torch.api.spec import STREAM_ORDERS, PartitionSpec

__all__ = [
    "PartitionSpec",
    "PartitionResult",
    "partition",
    "PartitionerInfo",
    "REGISTRY",
    "register",
    "get_info",
    "list_algorithms",
    "STREAM_ORDERS",
]
