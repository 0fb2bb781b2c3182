"""Restreaming (Nishimura & Ugander; Awadelkarim & Ugander) with CUTTANA as
the core partitioner (port of ``repro.core.restream``).

Pass 1 runs any partitioner the port has registered; passes 2..n re-stream
vertices with the FULL previous assignment visible, reassigning each vertex
greedily under the balance condition; an optional final refinement pass
applies phase-2 trades (:func:`~repro_torch.core.cuttana.refine_any`).

Each re-pass is a :class:`~repro_torch.core.engine.StreamEngine` run with
``ShardedImmediatePolicy(reassign=True)``: ``num_shards=1`` (the default) is
the sequential ``ImmediatePolicy(reassign=True)`` - one partition-score
kernel call per chunk with exact move corrections - while ``num_shards>=2``
runs every re-pass through the S-shard superstep core (one sharded kernel
call per superstep). Every re-pass's state starts from the previous pass's
assignment, so its device mirror of ``part_of`` is built from it before the
first launch.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.api.registry import get_info
from repro_torch.core import autotune
from repro_torch.core.base import FennelParams, PartitionState
from repro_torch.core.cuttana import refine_any
from repro_torch.core.engine import (
    EngineConfig,
    FennelScorer,
    ShardedImmediatePolicy,
    StreamEngine,
    _check_num_shards,
)
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph

__all__ = ["partition_restream"]


def partition_restream(
    graph: CSRGraph,
    k: int,
    passes: int = 3,
    base: str = "cuttana",
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    final_refine: bool = True,
    order: str = "random",
    seed: int = 0,
    chunk: int = 512,
    num_shards: int = 1,
    max_workers: int = 0,
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    device = resolve_device(device)
    # validate eagerly: with passes=1 no re-pass engine is ever built, and
    # with passes>=2 a late failure would waste the whole base partition.
    # num_shards=0 resolves through the auto-tuner like the parallel algos.
    if int(num_shards) == 0:
        num_shards = autotune.resolve(
            0, chunk, algo="restream", num_vertices=graph.num_vertices
        ).num_shards
    num_shards = _check_num_shards(num_shards)
    # raises for an unported base, naming the slice that brings it
    base_fn = get_info(base).resolve()
    t0 = time.perf_counter()
    base_telemetry: dict = {}
    part = base_fn(
        graph, k, epsilon=epsilon, balance_mode=balance_mode,
        order=order, seed=seed, telemetry=base_telemetry, device=device,
    )
    base_s = time.perf_counter() - t0
    kernel_calls = base_telemetry.get("kernel_calls", 0)
    t0 = time.perf_counter()
    deg = graph.degrees.astype(np.float64)
    params = FennelParams(hybrid=(balance_mode == "edge"))
    for p in range(1, passes):
        state = PartitionState.from_arrays(
            part,
            np.bincount(part, minlength=k).astype(np.float64),
            np.bincount(part, weights=deg, minlength=k),
            k=k,
            total_degree=int(graph.indices.shape[0]),
            epsilon=epsilon,
            balance_mode=balance_mode,
            seed=seed + p,
            device=device,
        )
        engine = StreamEngine(
            graph,
            state,
            FennelScorer(graph, k, params, balance_mode),
            ShardedImmediatePolicy(num_shards, reassign=True),
            order=order,
            seed=seed + p,
            config=EngineConfig(chunk=chunk, max_workers=max_workers),
        )
        engine.run()
        kernel_calls += engine.telemetry["kernel_calls"]
        part = state.part_of.copy()
    stream_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    if final_refine and k > 1:
        part = refine_any(
            graph, part, k, epsilon=epsilon, balance_mode=balance_mode,
            seed=seed, device=device,
        )
    if telemetry is not None:
        telemetry.update(
            passes=passes,
            base=base,
            num_shards=num_shards,
            kernel_calls=kernel_calls,
            base_seconds=base_s,
            stream_seconds=stream_s,
            refine_seconds=time.perf_counter() - t1,
        )
        if base_telemetry:
            # the base run's full counters survive namespaced; kernel_calls
            # above already sums them
            telemetry["base_telemetry"] = {
                key: val for key, val in base_telemetry.items()
                if not key.endswith("_seconds")
            }
    return part
