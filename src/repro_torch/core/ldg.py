"""Linear Deterministic Greedy (Stanton & Kliot, KDD'12).

score_i = |V_i ∩ N(v)| * (1 - size_i / C)   with capacity C per balance mode.

Port of ``repro.core.ldg``; runs through
:class:`repro_torch.core.engine.StreamEngine`, one kernel call per chunk.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.base import PartitionState, finalize
from repro_torch.core.engine import EngineConfig, ImmediatePolicy, LDGScorer, StreamEngine
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph


def partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "vertex",
    order: str = "natural",
    seed: int = 0,
    chunk: int = 512,
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    device = resolve_device(device)
    config = EngineConfig(chunk=chunk)
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=device)
    t0 = time.perf_counter()
    engine = StreamEngine(
        graph,
        state,
        LDGScorer(graph, k, balance_mode),
        ImmediatePolicy(),
        order=order,
        seed=seed,
        config=config,
    )
    engine.run()
    if telemetry is not None:
        telemetry.update(engine.telemetry)
        telemetry["stream_seconds"] = time.perf_counter() - t0
    return finalize(state)
