"""CUTTANA: prioritized buffered streaming + coarsened refinement (paper §III).

Port of ``repro.core.cuttana``: :func:`partition`, its phase 2,
:func:`partition_buffcut` (``cuttana-buffcut``: the same engine under the
``gain`` or ``completeness`` eviction priority) and :func:`refine_any`
(phase 2 applied to any partitioner's output).

Phase 1 (Algorithm 1) runs through
:class:`repro_torch.core.engine.StreamEngine`: ``use_buffer=True`` selects
:class:`~repro_torch.core.engine.BufferedPolicy`, whose placements are
scored one vertex at a time on the host and launch no kernel;
``use_buffer=False`` selects the chunked, kernel-backed
:class:`~repro_torch.core.engine.ImmediatePolicy`. Every placement also
picks a sub-partition (Def. 2).

Phase 2 builds the sub-partition graph on the device, then runs greedy
trades on the host until maximal (or early-stopped by ``thresh``); vertices
inherit their sub-partition's final partition.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.base import FennelParams, PartitionState, finalize
from repro_torch.core.engine import (
    BufferedPolicy,
    EngineConfig,
    FennelScorer,
    ImmediatePolicy,
    StreamEngine,
)
from repro_torch.core.refinement import Refiner, build_subpartition_graph
from repro_torch.core.subpartition import SubPartitioner, phase2_subpartitioner
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph


def _phase2_refine(
    graph: CSRGraph,
    subp: SubPartitioner,
    k: int,
    epsilon: float,
    balance_mode: str,
    thresh: float,
    max_moves: int | None,
    device: torch.device,
):
    """Merge + coarsen + refine (paper §III-B). Returns
    ``(part, sub_part, moves, cut_improvement)``, ``sub_part`` the final
    partition of each sub-partition."""
    w = build_subpartition_graph(graph, subp.sub_of, subp.kp, device).cpu().numpy()
    sub_part = np.repeat(np.arange(k, dtype=np.int64), subp.s)
    if balance_mode == "edge":
        size = subp.sub_e_counts.copy()
        total = float(graph.indices.shape[0])
    else:
        size = subp.sub_v_counts.copy()
        total = float(graph.num_vertices)
    refiner = Refiner(w, sub_part, size, k, epsilon, total_mass=total)
    stats = refiner.refine(thresh=thresh, max_moves=max_moves)
    sub_part = refiner.sub_part.copy()
    part = sub_part[subp.sub_of].astype(np.int32)
    return part, sub_part, stats.moves, stats.cut_improvement


@dataclasses.dataclass
class CuttanaResult:
    """Compat container for ``return_detail=True`` callers.

    Deprecated: the canonical surface is :func:`repro_torch.api.partition`,
    which folds these fields into ``PartitionResult.telemetry`` /
    ``.timings`` so every algorithm returns one uniform type.
    """

    part: np.ndarray
    sub_of: np.ndarray
    sub_part: np.ndarray  # final partition of each sub-partition
    refine_moves: int
    refine_improvement: float
    phase1_seconds: float
    phase2_seconds: float


def partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    d_max: int = 1000,
    max_qsize: int | None = None,
    theta: float = 1.0,
    subparts_per_partition: int | None = None,
    use_buffer: bool = True,
    use_refinement: bool = True,
    thresh: float = 0.0,
    max_moves: int | None = None,
    fennel_params: FennelParams | None = None,
    order: str = "natural",
    seed: int = 0,
    return_detail: bool = False,
    chunk: int = 512,
    prefetch: str = "auto",
    strategy: str = "eq6",
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
):
    """Full CUTTANA partitioner. ``use_buffer=False`` /
    ``use_refinement=False`` are the paper's Table III ablations.
    ``telemetry`` (if given) receives engine counters, phase wall times and
    refinement stats; ``return_detail=True`` is the compat flag that instead
    returns the legacy :class:`CuttanaResult`."""
    device = resolve_device(device)
    n = graph.num_vertices
    if max_qsize is None:
        max_qsize = max(1024, n // 10)  # paper: 1e6 for 10^7..10^8-vertex graphs
    if subparts_per_partition is None:
        # paper: K'/K = 4096 for big graphs; scale down for small ones so that
        # sub-partitions still hold >= ~8 vertices on average.
        subparts_per_partition = int(max(8, min(4096, n // (8 * k))))

    params = fennel_params or FennelParams(hybrid=(balance_mode == "edge"))
    config = EngineConfig(chunk=chunk, prefetch=prefetch)
    policy = (
        BufferedPolicy(max_qsize, d_max, theta, strategy=strategy)
        if use_buffer
        else ImmediatePolicy()
    )
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=device)
    refine = use_refinement and k > 1
    # the detail reports the sub-placement even when phase 2 does not run
    subp = phase2_subpartitioner(
        graph, k, subparts_per_partition, refine or return_detail, epsilon, balance_mode, seed
    )
    t0 = time.perf_counter()
    engine = StreamEngine(
        graph,
        state,
        FennelScorer(graph, k, params, balance_mode),
        policy,
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
    sub_part = None
    if refine:
        part, sub_part, moves, improvement = _phase2_refine(
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
    if return_detail:
        if sub_part is None:
            sub_part = np.repeat(np.arange(k, dtype=np.int64), subp.s)
        return CuttanaResult(
            part=part,
            sub_of=subp.sub_of.copy(),
            sub_part=sub_part,
            refine_moves=moves,
            refine_improvement=improvement,
            phase1_seconds=phase1_s,
            phase2_seconds=phase2_s,
        )
    return part


def refine_any(
    graph: CSRGraph,
    part: np.ndarray,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    subparts_per_partition: int | None = None,
    thresh: float = 0.0,
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Paper §III-B: refinement applies to *any* partitioner's output.

    Builds sub-partitions by re-streaming vertices (in id order, on the
    host) inside their fixed partition assignment, then runs phase-2 trades
    on the device-built sub-partition graph."""
    device = resolve_device(device)
    n = graph.num_vertices
    if subparts_per_partition is None:
        subparts_per_partition = int(max(8, min(4096, n // (8 * k))))
    subp = SubPartitioner(
        graph, k, subparts_per_partition, balance_mode=balance_mode, seed=seed
    )
    indptr, indices = graph.indptr, graph.indices
    for v in range(n):
        nbrs = indices[indptr[v] : indptr[v + 1]]
        subp.assign(v, int(part[v]), nbrs, nbrs.size)
    refined, _, _, _ = _phase2_refine(
        graph, subp, k, epsilon, balance_mode, thresh, None, device
    )
    return refined


def partition_buffcut(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    d_max: int = 1000,
    strategy: str = "gain",
    max_qsize: int | None = None,
    theta: float = 1.0,
    subparts_per_partition: int | None = None,
    use_refinement: bool = True,
    thresh: float = 0.0,
    max_moves: int | None = None,
    order: str = "natural",
    seed: int = 0,
    chunk: int = 512,
    prefetch: str = "auto",
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """``cuttana-buffcut``: CUTTANA's engine with a prioritized (non-Eq.-6)
    buffer-eviction strategy - ``"gain"`` (default) or ``"completeness"``.
    The spec layer rejects ``strategy="eq6"`` here (that spec spells
    ``algo="cuttana"``); this entry point exists so the variant's own
    defaults are the callable's defaults."""
    return partition(
        graph, k, epsilon=epsilon, balance_mode=balance_mode, d_max=d_max,
        max_qsize=max_qsize, theta=theta,
        subparts_per_partition=subparts_per_partition,
        use_refinement=use_refinement, thresh=thresh, max_moves=max_moves,
        order=order, seed=seed, chunk=chunk, prefetch=prefetch,
        strategy=strategy, telemetry=telemetry, device=device,
    )
