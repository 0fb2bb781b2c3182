"""The spec runner: ``partition(graph, spec, device=...) -> PartitionResult``.

Port of ``repro.api.runner``. Keyword arguments are built from the registry
entry, so a spec run calls the partitioner exactly as a hand-written call
would; assignments equal the reference's under the same spec.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.api.registry import build_spec_kwargs, get_info
from repro_torch.api.result import PartitionResult
from repro_torch.api.spec import PartitionSpec
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph

__all__ = ["partition"]

# telemetry keys that are phase wall times, surfaced into result.timings
_TIMING_KEYS = (
    "phase1_seconds",
    "phase2_seconds",
    "base_seconds",
    "stream_seconds",
    "refine_seconds",
)


def partition(
    graph: CSRGraph | None,
    spec: PartitionSpec | dict | str | None = None,
    /,
    device: str | torch.device | None = None,
    **overrides,
) -> PartitionResult:
    """Run ``spec`` on ``graph`` on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``).

    ``spec`` may be a :class:`PartitionSpec`, a dict of its fields, or an
    algorithm name; ``overrides`` are applied on top (e.g.
    ``partition(g, "cuttana", k=8, device="cpu")``). ``graph`` may be None
    when the spec has a ``source``; ``partition(spec)`` is the short form.

    Parallel algorithms additionally surface ``telemetry["profile"]`` (the
    per-superstep phase timings, see ``PartitionResult.profile``) and, when
    ``num_shards=0``/``"auto"`` or ``chunk=0`` was requested,
    ``telemetry["autotune"]`` recording the resolved knobs and their source.
    """
    device = resolve_device(device)
    if spec is None and isinstance(graph, (PartitionSpec, dict, str)):
        graph, spec = None, graph
    if spec is None:
        raise ValueError(
            "partition() needs a spec: a PartitionSpec, a dict of its "
            "fields, or an algorithm name"
        )
    if isinstance(spec, str):
        spec = PartitionSpec(algo=spec, **overrides)
    elif isinstance(spec, dict):
        spec = PartitionSpec.from_dict({**spec, **overrides})
    elif overrides:
        spec = spec.replace(**overrides)
    if graph is None:
        if spec.source is None:
            raise ValueError(
                "partition() needs a graph: pass one explicitly or set "
                "spec.source (rmat:<n>[:<avg_degree>] or dataset:<name>)"
            )
        from repro_torch.graph.generators import load_source

        graph = load_source(spec.source, seed=spec.seed)
    info = get_info(spec.algo)
    telemetry: dict = {}
    t0 = time.perf_counter()
    out = info.resolve()(
        graph, spec.k, telemetry=telemetry, device=device,
        **build_spec_kwargs(info, spec),
    )
    timings = {"total_s": time.perf_counter() - t0}
    for key in _TIMING_KEYS:
        if key in telemetry:
            timings[key] = telemetry.pop(key)
    telemetry.update(
        graph_backing="resident",
        peak_graph_bytes=int(graph.indptr.nbytes + graph.indices.nbytes),
        device=str(device),
    )
    return PartitionResult(
        spec=spec,
        graph=graph,
        assignment=np.asarray(out),
        device=device,
        timings=timings,
        telemetry=telemetry,
    )
