"""HeiStream-like buffered *batch* streaming partitioner (Faraj & Schulz;
port of ``repro.core.heistream_like``).

Each batch of ``batch_size`` stream vertices is placed greedily with the
FENNEL score - one :class:`~repro_torch.core.engine.StreamEngine` chunk,
whose histograms come from one gather-entry launch of the partition-score
kernel - then refined by FM-style passes inside the batch against the
partition loads. The FM passes run on the host as the engine's
``on_chunk_end`` hook (each move depends on the one before it); they move
only the batch's own vertices, so the engine writes just the batch's rows
of ``part_of`` into the device mirror after them, before the next launch.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.base import FennelParams, PartitionState, finalize
from repro_torch.core.engine import EngineConfig, FennelScorer, ImmediatePolicy, StreamEngine
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph

__all__ = ["partition"]


def partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "vertex",
    batch_size: int = 4096,
    fm_passes: int = 3,
    order: str = "natural",
    seed: int = 0,
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    device = resolve_device(device)
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=device)
    indptr, indices = graph.indptr, graph.indices
    rng = np.random.default_rng(seed)
    fm_moves = 0

    def fm_refine(eng: StreamEngine, batch: np.ndarray) -> None:
        # ---- FM-style refinement inside the batch
        nonlocal fm_moves
        for _ in range(fm_passes):
            moved = 0
            for v in rng.permutation(batch):
                v = int(v)
                nbrs = indices[indptr[v] : indptr[v + 1]]
                deg = nbrs.size
                cur = int(state.part_of[v])
                hist = state.neighbor_histogram(nbrs)
                gains = hist - hist[cur]  # edge-cut gain of moving v -> p
                if balance_mode == "vertex":
                    over = state.v_counts + 1 > state.vertex_capacity
                else:
                    over = state.e_counts + deg > state.edge_capacity
                over[cur] = False
                gains = np.where(over, -np.inf, gains)
                best = int(gains.argmax())
                if best != cur and gains[best] > 0:
                    state.part_of[v] = best
                    state.v_counts[cur] -= 1
                    state.v_counts[best] += 1
                    state.e_counts[cur] -= deg
                    state.e_counts[best] += deg
                    moved += 1
            fm_moves += moved
            if moved == 0:
                break
        # FM moved mass behind the scorer's back - refresh its penalty cache
        eng.scorer.begin(state)

    t0 = time.perf_counter()
    engine = StreamEngine(
        graph,
        state,
        FennelScorer(
            graph, k, FennelParams(hybrid=(balance_mode == "edge")), balance_mode
        ),
        ImmediatePolicy(),
        order=order,
        seed=seed,
        config=EngineConfig(chunk=batch_size),
        on_chunk_end=fm_refine,
    )
    engine.run()
    if telemetry is not None:
        telemetry.update(engine.telemetry)
        telemetry.update(
            stream_seconds=time.perf_counter() - t0, fm_moves=fm_moves
        )
    return finalize(state)
