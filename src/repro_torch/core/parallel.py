"""Parallel CUTTANA: shard-parallel buffered streaming (paper §V).

Port of ``repro.core.parallel``. The paper's headline systems claim is "a
parallel version for CUTTANA that offers nearly the same partitioning
latency as existing streaming partitioners". This module wires the sharded
bulk-synchronous policies of :mod:`repro_torch.core.engine` into full
partitioners:

* :func:`partition_parallel` (``cuttana-parallel``) - S shard-local priority
  buffers around one shared :class:`~repro_torch.core.base.PartitionState`;
  every superstep scores all shards' candidates in ONE call of the sharded
  partition-score kernel, exchanges assignments/loads at the boundary, and
  the usual merge -> coarsen -> refine phase 2 reconciles shard-boundary
  vertices afterwards.
* :func:`fennel_parallel` (``fennel-parallel``) - the same superstep core
  with immediate placement, i.e. a bulk-synchronous parallel FENNEL.

``num_shards=1`` is *defined* as the sequential engine (both wrappers build
the exact objects :mod:`repro_torch.core.cuttana` /
:mod:`repro_torch.core.fennel` build), so assignments are bit-identical to
``cuttana`` / ``fennel``. For S >= 2 assignments equal the reference's at
the same S, for every ``max_workers``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core.base import FennelParams, PartitionState, finalize
from repro_torch.core.cuttana import _phase2_refine
from repro_torch.core.engine import (
    EngineConfig,
    FennelScorer,
    ShardedBufferedPolicy,
    ShardedImmediatePolicy,
    StreamEngine,
)
from repro_torch.core.subpartition import phase2_subpartitioner
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph

__all__ = ["partition_parallel", "fennel_parallel"]


def _resolve_knobs(
    num_shards, chunk, *, algo: str, graph: CSRGraph, telemetry: dict | None
) -> tuple[int, int]:
    """Resolve ``num_shards=0``/"auto" and ``chunk=0`` through the tuning
    artifact (see :mod:`repro_torch.core.autotune`); record the source."""
    tuning = autotune.resolve(
        num_shards, chunk, algo=algo, num_vertices=graph.num_vertices
    )
    if telemetry is not None and tuning.source != "explicit":
        telemetry["autotune"] = {
            "num_shards": tuning.num_shards,
            "chunk": tuning.chunk,
            "source": tuning.source,
        }
    return tuning.num_shards, tuning.chunk


def partition_parallel(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    num_shards: int = 4,
    d_max: int = 1000,
    max_qsize: int | None = None,
    theta: float = 1.0,
    subparts_per_partition: int | None = None,
    use_refinement: bool = True,
    thresh: float = 0.0,
    max_moves: int | None = None,
    fennel_params: FennelParams | None = None,
    order: str = "natural",
    seed: int = 0,
    chunk: int = 512,
    max_workers: int = 0,
    prefetch: str = "auto",
    strategy: str = "eq6",
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Shard-parallel CUTTANA: Algorithm 1 over ``num_shards`` interleaved
    shard cursors with bulk-synchronous supersteps, then phase-2 refinement.

    ``num_shards=1`` is bit-identical to
    :func:`repro_torch.core.cuttana.partition` under the same knobs;
    ``num_shards=0`` resolves through the auto-tuner, as does ``chunk=0``.
    ``max_workers`` threads run the per-shard superstep tasks (0 = auto,
    ``min(num_shards, cpu_count)``); assignments are bit-identical for every
    worker count. ``telemetry`` additionally receives the parallel counters
    (``supersteps``, ``sync_rounds``, ``boundary_conflicts``,
    ``num_shards``, ``max_workers``) and the per-superstep ``profile``.
    """
    device = resolve_device(device)
    num_shards, chunk = _resolve_knobs(
        num_shards, chunk, algo="cuttana-parallel", graph=graph,
        telemetry=telemetry,
    )
    n = graph.num_vertices
    if max_qsize is None:
        max_qsize = max(1024, n // 10)
    if subparts_per_partition is None:
        subparts_per_partition = int(max(8, min(4096, n // (8 * k))))

    params = fennel_params or FennelParams(hybrid=(balance_mode == "edge"))
    config = EngineConfig(
        chunk=chunk, prefetch=prefetch, max_workers=max_workers
    )
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=device)
    refine = use_refinement and k > 1
    subp = phase2_subpartitioner(
        graph, k, subparts_per_partition, refine, epsilon, balance_mode, seed
    )
    t0 = time.perf_counter()
    engine = StreamEngine(
        graph,
        state,
        FennelScorer(graph, k, params, balance_mode),
        ShardedBufferedPolicy(num_shards, max_qsize, d_max, theta, strategy=strategy),
        subpartitioner=subp,
        order=order,
        seed=seed,
        config=config,
    )
    engine.run()
    phase1_s = time.perf_counter() - t0

    part = finalize(state)
    t1 = time.perf_counter()
    moves, improvement = 0, 0.0
    if refine:
        # merge + coarsen + refine: the trade pass that reconciles the
        # shard-boundary vertices the relaxed supersteps mis-scored
        part, _, moves, improvement = _phase2_refine(
            graph, subp, k, epsilon, balance_mode, thresh, max_moves, device
        )
    phase2_s = time.perf_counter() - t1

    if telemetry is not None:
        telemetry.update(engine.telemetry)
        telemetry.update(
            phase1_seconds=phase1_s,
            phase2_seconds=phase2_s,
            refine_moves=moves,
            refine_improvement=improvement,
            subpartitions=k * int(subparts_per_partition),
        )
    return part


def fennel_parallel(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "vertex",
    num_shards: int = 4,
    params: FennelParams | None = None,
    order: str = "natural",
    seed: int = 0,
    chunk: int = 512,
    max_workers: int = 0,
    prefetch: str = "auto",
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Bulk-synchronous parallel FENNEL over ``num_shards`` shard cursors.

    ``num_shards=1`` is bit-identical to
    :func:`repro_torch.core.fennel.partition`; ``num_shards=0`` / ``chunk=0``
    resolve through the auto-tuner, and ``max_workers`` (0 = auto) sets the
    shard-task thread count without affecting assignments.
    """
    device = resolve_device(device)
    num_shards, chunk = _resolve_knobs(
        num_shards, chunk, algo="fennel-parallel", graph=graph,
        telemetry=telemetry,
    )
    params = params or FennelParams()
    config = EngineConfig(
        chunk=chunk, prefetch=prefetch, max_workers=max_workers
    )
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=device)
    t0 = time.perf_counter()
    engine = StreamEngine(
        graph,
        state,
        FennelScorer(graph, k, params, balance_mode),
        ShardedImmediatePolicy(num_shards),
        order=order,
        seed=seed,
        config=config,
    )
    engine.run()
    if telemetry is not None:
        telemetry.update(engine.telemetry)
        telemetry["stream_seconds"] = time.perf_counter() - t0
    return finalize(state)
