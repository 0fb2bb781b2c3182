"""PyTorch/CUDA port of the CUTTANA reproduction (``repro``).

The package mirrors ``repro``'s layout (``graph/``, ``core/``,
``kernels/partition_score/``, ``api/``) and runs the partitioning pipeline
``PartitionSpec -> repro_torch.api.partition -> PartitionResult.quality()``
for ``fennel``, ``ldg`` and ``cuttana`` (sequential) and ``fennel-parallel``,
``cuttana-parallel`` and ``cuttana-restream`` (the sharded superstep
engine). Every entry point takes ``device`` (default ``"cuda"``); without a
card it raises unless the caller passes ``device="cpu"``. It imports neither
``jax`` nor ``repro``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
