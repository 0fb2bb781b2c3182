"""The spec runner: ``partition(graph, spec, device=...) -> PartitionResult``.

Port of ``repro.api.runner``. Keyword arguments are built from the registry
entry, so a spec run calls the partitioner exactly as a hand-written call
would; assignments (and a vertex-cut run's edge partition) equal the
reference's under the same spec. The device is resolved before anything
else, so a request for a missing card raises for every algorithm, the host
ones (``random``, ``hdrf``, the per-vertex ``*-legacy`` loops) included.
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
    Vertex-cut algorithms (``hdrf``, ``ginger``) return their
    :class:`~repro_torch.core.hdrf.EdgePartition` as
    ``result.edge_partition``; ``result.assignment`` is its ``edge_part``.
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
                "spec.source (rmat:<n>, dataset:<name>, or a graph path)"
            )
        from repro_torch.graph.external import load_graph_source

        graph = load_graph_source(spec.source, seed=spec.seed)
    info = get_info(spec.algo)
    kwargs = build_spec_kwargs(info, spec)
    telemetry: dict = {}
    if info.telemetry:
        kwargs["telemetry"] = telemetry
    t0 = time.perf_counter()
    out = info.resolve()(graph, spec.k, device=device, **kwargs)
    timings = {"total_s": time.perf_counter() - t0}
    edge_partition = None
    if info.kind == "vertex-cut":
        edge_partition = out
        assignment = np.asarray(out.edge_part)
    else:
        assignment = np.asarray(out)
    for key in _TIMING_KEYS:
        if key in telemetry:
            timings[key] = telemetry.pop(key)
    # graph-memory accounting, the reference's: for a mapped (out-of-core)
    # graph the resident footprint is just its host-side caches and
    # mapped_graph_bytes the file-backed rest; for an in-memory CSR it is the
    # whole structure
    backing = getattr(graph, "backing", "resident")
    if backing == "mapped":
        peak_graph_bytes = int(graph.nbytes_resident)
        mapped_graph_bytes = int(graph.nbytes_mapped)
    else:
        peak_graph_bytes = int(graph.indptr.nbytes + graph.indices.nbytes)
        mapped_graph_bytes = 0
    telemetry.update(
        graph_backing=backing,
        peak_graph_bytes=peak_graph_bytes,
        mapped_graph_bytes=mapped_graph_bytes,
        # block-compressed (v2) on-disk payload: byte index + varint data;
        # 0 for raw v1 files and resident graphs
        compressed_graph_bytes=int(getattr(graph, "nbytes_compressed", 0) or 0),
        device=str(device),
    )
    return PartitionResult(
        spec=spec,
        graph=graph,
        assignment=assignment,
        device=device,
        timings=timings,
        telemetry=telemetry,
        edge_partition=edge_partition,
    )
