"""Declarative partitioner registry (port of ``repro.api.registry``): the
single source of truth for the port's zoo.

Every algorithm the reference registers is registered here with the
reference's metadata - ``kind``, ``placement``, ``engine``,
``balance_modes``, ``common``, ``forward_exclude``,
``fennel_params_fields``, ``telemetry``, ``description`` - and its typed
params block; only the callables (``"module:attr"``, resolved lazily) are
the port's. ``PartitionSpec`` validates against these entries, and
:func:`repro_torch.api.partition` uses them to drive any algorithm the same
way. Every registered callable also takes ``device``.
"""
from __future__ import annotations

import dataclasses
import difflib
import importlib
from typing import Any, Callable

__all__ = [
    "PartitionerInfo",
    "REGISTRY",
    "register",
    "get_info",
    "list_algorithms",
    "unknown_algorithm_error",
    "FennelAlgoParams",
    "LDGAlgoParams",
    "CuttanaAlgoParams",
    "CuttanaBuffcutAlgoParams",
    "CuttanaParallelAlgoParams",
    "FennelParallelAlgoParams",
    "CuttanaBatchedAlgoParams",
    "HeiStreamAlgoParams",
    "RestreamAlgoParams",
    "IncrementalAlgoParams",
    "HDRFAlgoParams",
    "ClusterAlgoParams",
]

# common spec fields a partitioner accepts as keyword arguments
_STREAM_COMMON = ("epsilon", "balance_mode", "order", "seed")


# ------------------------------------------------------- typed params blocks
@dataclasses.dataclass(frozen=True)
class FennelAlgoParams:
    """FENNEL knobs (paper Eq. 7). ``hybrid`` only bites in edge mode.
    ``prefetch`` is the decode-ahead switch for memory-mapped graphs
    ("auto"/"on"/"off", see :class:`~repro_torch.core.engine.EngineConfig`);
    it never changes assignments."""

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
    """CUTTANA Algorithm 1 + phase-2 knobs (paper §III). ``strategy``
    selects the buffer-eviction priority (:mod:`repro_torch.core.priority`);
    ``"eq6"`` is the paper's Eq. 6."""

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
class CuttanaBuffcutAlgoParams:
    """BuffCut-style prioritized buffered streaming: CUTTANA's engine with a
    non-Eq.-6 eviction priority (``"gain"`` delayed-decision margin scoring
    or ``"completeness"`` neighbourhood-completeness; ``"eq6"`` is rejected -
    that spec spells ``algo="cuttana"``)."""

    d_max: int = 1000
    strategy: str = "gain"
    max_qsize: int | None = None
    theta: float = 1.0
    subparts_per_partition: int | None = None
    use_refinement: bool = True
    thresh: float = 0.0
    max_moves: int | None = None
    chunk: int = 512
    prefetch: str = "auto"


@dataclasses.dataclass(frozen=True)
class ClusterAlgoParams:
    """Streaming-clustering coarsening prepass (:mod:`repro_torch.core.cluster`)
    around an engine base partitioner: ``hub_degree`` keeps hubs as
    singleton supervertices, ``cluster_cap_frac`` bounds each cluster to a
    fraction of one partition's mass."""

    hub_degree: int = 1000
    cluster_cap_frac: float = 0.1
    use_refinement: bool = True
    thresh: float = 0.0
    subparts_per_partition: int | None = None
    chunk: int = 512


@dataclasses.dataclass(frozen=True)
class CuttanaParallelAlgoParams:
    """Shard-parallel CUTTANA (paper §V): ``num_shards`` interleaved shard
    cursors with bulk-synchronous supersteps around the Algorithm 1 knobs.

    ``num_shards=0`` (or the spec string ``"auto"``) and ``chunk=0`` resolve
    through the auto-tuner (:mod:`repro_torch.core.autotune`); ``max_workers`` is
    the shard-task thread count (0 = auto, ``min(num_shards, cpu_count)``) -
    it changes wall-clock only, never assignments."""

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
class CuttanaBatchedAlgoParams:
    """Chunk-parallel variant: stale histograms + degree-capped sampling."""

    chunk: int = 512
    sample_cap: int = 512
    use_refinement: bool = True
    subparts_per_partition: int | None = None
    thresh: float = 0.0


@dataclasses.dataclass(frozen=True)
class HeiStreamAlgoParams:
    batch_size: int = 4096
    fm_passes: int = 3


@dataclasses.dataclass(frozen=True)
class RestreamAlgoParams:
    """Restream knobs. ``num_shards=1`` is the sequential restream;
    ``num_shards>=2`` runs every re-pass through the S-shard superstep core
    (same parallel engine as ``cuttana-parallel``); ``num_shards=0`` auto-
    tunes and ``max_workers`` (0 = auto) sets the shard-task threads."""

    passes: int = 3
    base: str = "cuttana"
    final_refine: bool = True
    chunk: int = 512
    num_shards: int = 1
    max_workers: int = 0


@dataclasses.dataclass(frozen=True)
class IncrementalAlgoParams:
    """Incremental (churn) mode knobs. ``num_batches`` splits the replayed
    arrival stream; a batch whose edge-cut drifts past ``drift_threshold``
    (relative to the last re-stream point) triggers a windowed local
    re-stream over at most ``window_frac`` of the seen vertices.
    ``num_shards=0``/``"auto"`` auto-tunes; ``max_workers`` (0 = auto) never
    changes assignments."""

    num_batches: int = 16
    drift_threshold: float = 0.10
    window_frac: float = 0.25
    num_shards: int = 1
    max_workers: int = 0
    chunk: int = 512


@dataclasses.dataclass(frozen=True)
class HDRFAlgoParams:
    lam: float = 4.0


# ------------------------------------------------------------------- entries
@dataclasses.dataclass(frozen=True)
class PartitionerInfo:
    """One registry entry.

    ``kind``:       "edge-cut" (vertex partitioner) | "vertex-cut" (edge
                    partitioner returning an ``EdgePartition``).
    ``placement``:  "immediate" | "buffered" | "restream" | "static".
    ``engine``:     "engine" (StreamEngine-backed) | "legacy" (preserved seed
                    loop) | "none" (no streaming scoring core).
    ``balance_modes``: balance conditions the algorithm enforces; empty means
                    the spec's ``balance_mode`` is not applicable.
    ``common``:     which of (epsilon, balance_mode, order, seed) the
                    callable accepts.
    ``params_cls``: frozen dataclass of per-algorithm knobs, or None.
    ``forward_exclude``: params-block fields *not* forwarded to the callable
                    (legacy loops predate some engine knobs, e.g. ``chunk``).
    ``fennel_params_fields``: params-block fields packed into a
                    :class:`repro_torch.core.base.FennelParams` passed as
                    ``params=`` (FENNEL's historical calling convention).
    """

    name: str
    entry: str  # "module:attr", resolved lazily
    kind: str
    placement: str
    engine: str
    balance_modes: tuple[str, ...] = ()
    common: tuple[str, ...] = ()
    params_cls: type | None = None
    forward_exclude: tuple[str, ...] = ()
    fennel_params_fields: tuple[str, ...] = ()
    telemetry: bool = False
    description: str = ""

    def resolve(self) -> Callable:
        mod, _, attr = self.entry.partition(":")
        return getattr(importlib.import_module(mod), attr)

    def param_names(self) -> tuple[str, ...]:
        if self.params_cls is None:
            return ()
        return tuple(f.name for f in dataclasses.fields(self.params_cls))


REGISTRY: dict[str, PartitionerInfo] = {}


def register(info: PartitionerInfo) -> PartitionerInfo:
    if info.name in REGISTRY:
        raise ValueError(f"partitioner {info.name!r} already registered")
    REGISTRY[info.name] = info
    return info


def list_algorithms(kind: str | None = None) -> list[str]:
    return sorted(n for n, i in REGISTRY.items() if kind is None or i.kind == kind)


def unknown_algorithm_error(name: str, kind: str | None = None) -> ValueError:
    names = list_algorithms(kind)
    msg = f"unknown partitioner {name!r}; registered: {', '.join(names)}"
    close = difflib.get_close_matches(name, names, n=1)
    if close:
        msg += f". Did you mean {close[0]!r}?"
    return ValueError(msg)


def get_info(name: str, kind: str | None = None) -> PartitionerInfo:
    info = REGISTRY.get(name)
    if info is None:
        raise unknown_algorithm_error(name, kind)
    if kind is not None and info.kind != kind:
        raise ValueError(
            f"partitioner {name!r} is {info.kind}, not {kind} "
            f"(registered {kind} algorithms: {', '.join(list_algorithms(kind))})"
        )
    return info


def _register_all() -> None:
    both = ("vertex", "edge")
    entries = [
        # ---- engine-backed canonical streaming partitioners (edge-cut)
        PartitionerInfo(
            "cuttana", "repro_torch.core.cuttana:partition", "edge-cut", "buffered",
            "engine", both, _STREAM_COMMON, CuttanaAlgoParams, telemetry=True,
            description="CUTTANA: prioritized buffered streaming + coarsened refinement",
        ),
        PartitionerInfo(
            "cuttana-buffcut", "repro_torch.core.cuttana:partition_buffcut", "edge-cut",
            "buffered", "engine", both, _STREAM_COMMON,
            CuttanaBuffcutAlgoParams, telemetry=True,
            description="BuffCut-style prioritized buffered streaming "
                        "(gain/completeness eviction priorities)",
        ),
        PartitionerInfo(
            "cluster+cuttana", "repro_torch.core.cluster:partition_cluster_cuttana",
            "edge-cut", "buffered", "engine", both, _STREAM_COMMON,
            ClusterAlgoParams, telemetry=True,
            description="streaming-clustering coarsening prepass around CUTTANA",
        ),
        PartitionerInfo(
            "cluster+fennel", "repro_torch.core.cluster:partition_cluster_fennel",
            "edge-cut", "immediate", "engine", both, _STREAM_COMMON,
            ClusterAlgoParams, telemetry=True,
            description="streaming-clustering coarsening prepass around FENNEL",
        ),
        PartitionerInfo(
            "cuttana-batched", "repro_torch.core.cuttana_batched:partition_batched",
            "edge-cut", "immediate", "engine", both, _STREAM_COMMON,
            CuttanaBatchedAlgoParams, telemetry=True,
            description="chunk-parallel CUTTANA (stale histograms + sampling)",
        ),
        PartitionerInfo(
            "cuttana-parallel", "repro_torch.core.parallel:partition_parallel",
            "edge-cut", "buffered", "engine", both, _STREAM_COMMON,
            CuttanaParallelAlgoParams, telemetry=True,
            description="shard-parallel CUTTANA (S buffered shard frontiers, "
                        "bulk-synchronous supersteps)",
        ),
        PartitionerInfo(
            "fennel-parallel", "repro_torch.core.parallel:fennel_parallel",
            "edge-cut", "immediate", "engine", both, _STREAM_COMMON,
            FennelParallelAlgoParams,
            fennel_params_fields=("gamma", "alpha_scale", "hybrid"),
            telemetry=True,
            description="bulk-synchronous parallel FENNEL (S shard frontiers)",
        ),
        PartitionerInfo(
            "cuttana-restream", "repro_torch.core.restream:partition_restream",
            "edge-cut", "restream", "engine", both, _STREAM_COMMON,
            RestreamAlgoParams, telemetry=True,
            description="restreaming with CUTTANA as the core partitioner",
        ),
        PartitionerInfo(
            "cuttana-incremental",
            "repro_torch.core.incremental:partition_incremental",
            "edge-cut", "restream", "engine", both, _STREAM_COMMON,
            IncrementalAlgoParams, telemetry=True,
            description="incremental partitioning under churn: live-load "
                        "streaming placement + drift-triggered windowed "
                        "re-streams",
        ),
        PartitionerInfo(
            "fennel", "repro_torch.core.fennel:partition", "edge-cut", "immediate",
            "engine", both, _STREAM_COMMON, FennelAlgoParams,
            fennel_params_fields=("gamma", "alpha_scale", "hybrid"),
            telemetry=True,
            description="FENNEL streaming partitioner (Eq. 7 baseline)",
        ),
        PartitionerInfo(
            "ldg", "repro_torch.core.ldg:partition", "edge-cut", "immediate",
            "engine", both, _STREAM_COMMON, LDGAlgoParams, telemetry=True,
            description="Linear Deterministic Greedy",
        ),
        PartitionerInfo(
            "heistream", "repro_torch.core.heistream_like:partition", "edge-cut",
            "buffered", "engine", both, _STREAM_COMMON, HeiStreamAlgoParams,
            telemetry=True,
            description="HeiStream-like buffered batch streaming + FM refinement",
        ),
        # ---- trivial baselines
        PartitionerInfo(
            "random", "repro_torch.core.random_hash:partition_random", "edge-cut",
            "static", "none", (), ("seed",),
            description="uniform random assignment",
        ),
        PartitionerInfo(
            "hash", "repro_torch.core.random_hash:partition_hash", "edge-cut",
            "static", "none",
            description="splitmix-style id hash",
        ),
        PartitionerInfo(
            "chunked", "repro_torch.core.random_hash:partition_chunked", "edge-cut",
            "static", "none",
            description="contiguous id ranges (range partitioning)",
        ),
        # ---- preserved seed loops (parity baselines / benchmarks)
        PartitionerInfo(
            "cuttana-legacy", "repro_torch.core.legacy:cuttana_partition", "edge-cut",
            "buffered", "legacy", both, _STREAM_COMMON, CuttanaAlgoParams,
            forward_exclude=("chunk", "prefetch", "strategy"),
            description="seed per-vertex CUTTANA loop",
        ),
        PartitionerInfo(
            "cuttana-batched-legacy", "repro_torch.core.legacy:cuttana_batched_partition",
            "edge-cut", "immediate", "legacy", both, _STREAM_COMMON,
            CuttanaBatchedAlgoParams,
            description="seed chunk-parallel CUTTANA loop",
        ),
        PartitionerInfo(
            "fennel-legacy", "repro_torch.core.legacy:fennel_partition", "edge-cut",
            "immediate", "legacy", both, _STREAM_COMMON, FennelAlgoParams,
            forward_exclude=("chunk", "prefetch"),
            fennel_params_fields=("gamma", "alpha_scale", "hybrid"),
            description="seed per-vertex FENNEL loop",
        ),
        PartitionerInfo(
            "ldg-legacy", "repro_torch.core.legacy:ldg_partition", "edge-cut",
            "immediate", "legacy", both, _STREAM_COMMON,
            description="seed per-vertex LDG loop",
        ),
        PartitionerInfo(
            "heistream-legacy", "repro_torch.core.legacy:heistream_partition",
            "edge-cut", "buffered", "legacy", both, _STREAM_COMMON,
            HeiStreamAlgoParams,
            description="seed HeiStream-like loop",
        ),
        # ---- streaming edge partitioners (vertex-cut)
        PartitionerInfo(
            "hdrf", "repro_torch.core.hdrf:partition_hdrf", "vertex-cut",
            "immediate", "none", (), ("seed",), HDRFAlgoParams,
            description="HDRF vertex-cut edge partitioner",
        ),
        PartitionerInfo(
            "ginger", "repro_torch.core.hdrf:partition_ginger", "vertex-cut",
            "immediate", "none", (), ("seed",),
            description="Ginger-like hybrid-cut edge partitioner",
        ),
    ]
    for e in entries:
        register(e)


_register_all()


def build_spec_kwargs(info: PartitionerInfo, spec: Any) -> dict:
    """Keyword arguments that reproduce ``spec`` through ``info.resolve()``.

    Values equal the callable's own defaults when the params block is
    default-constructed, so a spec run is bit-identical to a bare call. The
    runner adds ``device`` (every callable takes it) and ``telemetry``
    (where ``info.telemetry``).
    """
    kwargs = {name: getattr(spec, name) for name in info.common}
    if spec.params is not None:
        block = dataclasses.asdict(spec.params)
        for name in info.forward_exclude:
            block.pop(name, None)
        if info.fennel_params_fields:
            from repro_torch.core.base import FennelParams

            fp = {f: block.pop(f) for f in info.fennel_params_fields}
            kwargs["params"] = FennelParams(**fp)
        kwargs.update(block)
    return kwargs
