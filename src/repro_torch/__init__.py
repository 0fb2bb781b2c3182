"""PyTorch/CUDA port of the CUTTANA reproduction (``repro``).

The package mirrors ``repro``'s layout (``graph/``, ``core/``,
``analytics/``, ``kernels/``, ``api/``) and runs the partitioning pipeline
``PartitionSpec -> repro_torch.api.partition -> PartitionResult.quality()``
for every algorithm the reference registers (the streaming partitioners on
the sequential and sharded engines, the ``*-legacy`` seed loops, the
trivial baselines and the vertex-cut HDRF/Ginger), and the analytics study
``PartitionResult.analytics()``
(PageRank/CC/SSSP on a partition). Every entry point takes ``device`` (default ``"cuda"``); without a
card it raises unless the caller passes ``device="cpu"``. It imports neither
``jax`` nor ``repro``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
