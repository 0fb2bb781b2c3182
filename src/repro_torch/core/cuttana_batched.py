"""Chunk-parallel CUTTANA, ``cuttana-batched`` (port of
``repro.core.cuttana_batched``).

The stream is consumed in chunks of C vertices. Each chunk's C x K
neighbour histograms come from one gather-entry launch of the
partition-score kernel against the chunk-start ``part_of`` (one chunk
stale - the bulk-synchronous relaxation); rows above ``sample_cap``
neighbours are scored on a seeded uniform sample through one dense-entry
launch, their counts rescaled (Thm. 1: exact counts matter least for
them). A host loop then places the chunk in stream order against exact
partition sizes. A thin configuration of
:class:`~repro_torch.core.engine.StreamEngine` (``ImmediatePolicy`` with
``exact=False``); phase 2 is CUTTANA's refinement.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.base import FennelParams, PartitionState, finalize
from repro_torch.core.cuttana import _phase2_refine
from repro_torch.core.engine import EngineConfig, FennelScorer, ImmediatePolicy, StreamEngine
from repro_torch.core.subpartition import phase2_subpartitioner
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph

__all__ = ["partition_batched"]


def partition_batched(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    chunk: int = 512,
    sample_cap: int = 512,
    use_refinement: bool = True,
    subparts_per_partition: int | None = None,
    thresh: float = 0.0,
    order: str = "natural",
    seed: int = 0,
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    device = resolve_device(device)
    n = graph.num_vertices
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=device)
    if subparts_per_partition is None:
        subparts_per_partition = int(max(8, min(4096, n // (8 * k))))
    refine = use_refinement and k > 1
    subp = phase2_subpartitioner(
        graph, k, subparts_per_partition, refine, epsilon, balance_mode, seed
    )
    params = FennelParams(hybrid=(balance_mode == "edge"))
    t0 = time.perf_counter()
    engine = StreamEngine(
        graph,
        state,
        FennelScorer(graph, k, params, balance_mode),
        ImmediatePolicy(),
        subpartitioner=subp,
        order=order,
        seed=seed,
        config=EngineConfig(chunk=chunk, sample_cap=sample_cap, exact=False),
    )
    engine.run()
    stream_s = time.perf_counter() - t0

    part = finalize(state)
    moves, improvement = 0, 0.0
    t1 = time.perf_counter()
    if refine:
        part, _, moves, improvement = _phase2_refine(
            graph, subp, k, epsilon, balance_mode, thresh, None, device
        )
    if telemetry is not None:
        telemetry.update(engine.telemetry)
        telemetry.update(
            stream_seconds=stream_s,
            refine_seconds=time.perf_counter() - t1,
            refine_moves=moves,
            refine_improvement=improvement,
            subpartitions=k * int(subparts_per_partition),
        )
    return part
