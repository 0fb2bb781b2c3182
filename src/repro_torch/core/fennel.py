"""FENNEL streaming vertex partitioner (Tsourakakis et al., WSDM'14).

Port of ``repro.core.fennel``: the paper's primary baseline and the scoring
core CUTTANA builds on (Eq. 7). ``hybrid=True`` + ``balance_mode="edge"``
is the edge-balanced variant. Runs through
:class:`repro_torch.core.engine.StreamEngine`, one kernel call per chunk.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.base import FennelParams, PartitionState, finalize
from repro_torch.core.engine import EngineConfig, FennelScorer, ImmediatePolicy, StreamEngine
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph


def partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "vertex",
    params: FennelParams | None = None,
    order: str = "natural",
    seed: int = 0,
    chunk: int = 512,
    prefetch: str = "auto",
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    device = resolve_device(device)
    params = params or FennelParams()
    config = EngineConfig(chunk=chunk, prefetch=prefetch)
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=device)
    t0 = time.perf_counter()
    engine = StreamEngine(
        graph,
        state,
        FennelScorer(graph, k, params, balance_mode),
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
