"""Declarative partitioner registry (port of ``repro.api.registry``).

The port registers the algorithms of its first two slices - ``fennel``,
``ldg``, ``cuttana`` (slice 1) and ``fennel-parallel``, ``cuttana-parallel``,
``cuttana-restream`` (slice 2) - with the reference's typed params blocks.
Every other name the reference registers raises a ``ValueError`` that names
the slice of the port that brings it.
"""
from __future__ import annotations

import dataclasses
import difflib
import importlib
from typing import Any, Callable

__all__ = [
    "PartitionerInfo",
    "REGISTRY",
    "get_info",
    "list_algorithms",
    "FennelAlgoParams",
    "LDGAlgoParams",
    "CuttanaAlgoParams",
    "CuttanaParallelAlgoParams",
    "FennelParallelAlgoParams",
    "RestreamAlgoParams",
]

# common spec fields a partitioner accepts as keyword arguments
_STREAM_COMMON = ("epsilon", "balance_mode", "order", "seed")


# ------------------------------------------------------- typed params blocks
@dataclasses.dataclass(frozen=True)
class FennelAlgoParams:
    """FENNEL knobs (paper Eq. 7). ``hybrid`` only bites in edge mode."""

    gamma: float = 1.5
    alpha_scale: float = 1.0
    hybrid: bool = True
    chunk: int = 512
    prefetch: str = "auto"


@dataclasses.dataclass(frozen=True)
class LDGAlgoParams:
    chunk: int = 512


@dataclasses.dataclass(frozen=True)
class CuttanaAlgoParams:
    """CUTTANA Algorithm 1 + phase-2 knobs (paper §III). ``strategy`` is the
    buffer-eviction priority; ``"eq6"`` is the paper's Eq. 6."""

    d_max: int = 1000
    max_qsize: int | None = None
    theta: float = 1.0
    subparts_per_partition: int | None = None
    use_buffer: bool = True
    use_refinement: bool = True
    thresh: float = 0.0
    max_moves: int | None = None
    chunk: int = 512
    prefetch: str = "auto"
    strategy: str = "eq6"


@dataclasses.dataclass(frozen=True)
class CuttanaParallelAlgoParams:
    """Shard-parallel CUTTANA (paper §V): ``num_shards`` interleaved shard
    cursors with bulk-synchronous supersteps around the Algorithm 1 knobs.

    ``num_shards=0`` (or the spec string ``"auto"``) and ``chunk=0`` resolve
    through the auto-tuner (:mod:`repro_torch.core.autotune`);
    ``max_workers`` is the shard-task thread count (0 = auto,
    ``min(num_shards, cpu_count)``) - it changes wall-clock only, never
    assignments."""

    num_shards: int = 4
    d_max: int = 1000
    max_qsize: int | None = None
    theta: float = 1.0
    subparts_per_partition: int | None = None
    use_refinement: bool = True
    thresh: float = 0.0
    max_moves: int | None = None
    chunk: int = 512
    max_workers: int = 0
    prefetch: str = "auto"
    strategy: str = "eq6"


@dataclasses.dataclass(frozen=True)
class FennelParallelAlgoParams:
    """Bulk-synchronous parallel FENNEL: ``num_shards`` shard frontiers.
    ``num_shards=0``/``"auto"`` and ``chunk=0`` auto-tune; ``max_workers=0``
    means auto."""

    num_shards: int = 4
    gamma: float = 1.5
    alpha_scale: float = 1.0
    hybrid: bool = True
    chunk: int = 512
    max_workers: int = 0
    prefetch: str = "auto"


@dataclasses.dataclass(frozen=True)
class RestreamAlgoParams:
    """Restream knobs. ``num_shards=1`` is the sequential restream;
    ``num_shards>=2`` runs every re-pass through the S-shard superstep core
    (the same parallel engine as ``cuttana-parallel``); ``num_shards=0``
    auto-tunes and ``max_workers`` (0 = auto) sets the shard-task threads.
    ``base`` is any algorithm the port has registered."""

    passes: int = 3
    base: str = "cuttana"
    final_refine: bool = True
    chunk: int = 512
    num_shards: int = 1
    max_workers: int = 0


# ------------------------------------------------------------------- entries
@dataclasses.dataclass(frozen=True)
class PartitionerInfo:
    """One registry entry: the callable (``"module:attr"``, resolved
    lazily; it accepts every common spec field) and its typed params block.
    ``fennel_params_fields`` are packed into a ``FennelParams`` passed as
    ``params=``."""

    name: str
    entry: str
    params_cls: type
    fennel_params_fields: tuple[str, ...] = ()

    def resolve(self) -> Callable:
        mod, _, attr = self.entry.partition(":")
        return getattr(importlib.import_module(mod), attr)


REGISTRY: dict[str, PartitionerInfo] = {
    info.name: info
    for info in (
        PartitionerInfo("cuttana", "repro_torch.core.cuttana:partition", CuttanaAlgoParams),
        PartitionerInfo(
            "cuttana-parallel", "repro_torch.core.parallel:partition_parallel",
            CuttanaParallelAlgoParams,
        ),
        PartitionerInfo(
            "cuttana-restream", "repro_torch.core.restream:partition_restream",
            RestreamAlgoParams,
        ),
        PartitionerInfo(
            "fennel", "repro_torch.core.fennel:partition", FennelAlgoParams,
            fennel_params_fields=("gamma", "alpha_scale", "hybrid"),
        ),
        PartitionerInfo(
            "fennel-parallel", "repro_torch.core.parallel:fennel_parallel",
            FennelParallelAlgoParams,
            fennel_params_fields=("gamma", "alpha_scale", "hybrid"),
        ),
        PartitionerInfo("ldg", "repro_torch.core.ldg:partition", LDGAlgoParams),
    )
}

# the reference's other algorithms and the slice of the port that brings each
_LATER = dict.fromkeys(
    (
        "cuttana-buffcut", "cluster+cuttana", "cluster+fennel",
        "cuttana-batched", "cuttana-incremental", "heistream", "random",
        "hash", "chunked", "cuttana-legacy", "cuttana-batched-legacy",
        "fennel-legacy", "ldg-legacy", "heistream-legacy", "hdrf", "ginger",
    ),
    "slice 4 (the rest of the partitioner zoo)",
)


def list_algorithms() -> list[str]:
    return sorted(REGISTRY)


def get_info(name: str) -> PartitionerInfo:
    info = REGISTRY.get(name)
    if info is not None:
        return info
    if name in _LATER:
        raise ValueError(
            f"partitioner {name!r} is not ported yet: it arrives with "
            f"{_LATER[name]} of the port; ported now: {', '.join(list_algorithms())}"
        )
    msg = f"unknown partitioner {name!r}; registered: {', '.join(list_algorithms())}"
    close = difflib.get_close_matches(name, list_algorithms(), n=1)
    if close:
        msg += f". Did you mean {close[0]!r}?"
    raise ValueError(msg)


def build_spec_kwargs(info: PartitionerInfo, spec: Any) -> dict:
    """Keyword arguments that reproduce ``spec`` through ``info.resolve()``."""
    kwargs = {name: getattr(spec, name) for name in _STREAM_COMMON}
    block = dataclasses.asdict(spec.params)
    if info.fennel_params_fields:
        from repro_torch.core.base import FennelParams

        fp = {f: block.pop(f) for f in info.fennel_params_fields}
        kwargs["params"] = FennelParams(**fp)
    kwargs.update(block)
    return kwargs
