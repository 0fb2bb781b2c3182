"""``PartitionResult``: the result of a spec run (port of
``repro.api.result``: :meth:`PartitionResult.quality`, the parallel engine's
:attr:`PartitionResult.profile`, the analytics study
:meth:`PartitionResult.analytics`, the graph-DB study
:meth:`PartitionResult.db`, partition-aware serving
:meth:`PartitionResult.serve` / :meth:`PartitionResult.serve_bench`, and
the CLI's report :meth:`PartitionResult.to_report`).

The DB study and the service run on the host over the result's host
arrays, as in the reference; ``device`` is where the partition was made.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from repro_torch.api.spec import PartitionSpec
from repro_torch.graph.csr import CSRGraph

if TYPE_CHECKING:
    from repro_torch.analytics.localize import LocalizedGraph

__all__ = ["PartitionResult", "jsonify"]


@dataclasses.dataclass(eq=False)  # ndarray fields make generated __eq__ raise
class PartitionResult:
    """``assignment`` is the algorithm's native output: the vertex->partition
    array (int32[|V|]) for edge-cut algorithms, the edge->partition array
    (over ``graph.edges_array()``) for vertex-cut ones, whose full
    :class:`~repro_torch.core.hdrf.EdgePartition` (replicas, masters) is
    ``edge_partition``. ``device`` is where the run and the quality scans
    execute."""

    spec: PartitionSpec
    graph: CSRGraph
    assignment: np.ndarray
    device: torch.device
    timings: dict = dataclasses.field(default_factory=dict)
    telemetry: dict = dataclasses.field(default_factory=dict)
    edge_partition: Any = None
    _quality: dict | None = dataclasses.field(default=None, repr=False)
    _localized: LocalizedGraph | None = dataclasses.field(default=None, repr=False)

    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def is_vertex_cut(self) -> bool:
        return self.edge_partition is not None

    @property
    def profile(self) -> dict | None:
        """Per-superstep wall-clock profile from the parallel engine
        (``None`` for sequential algorithms): worker count, queue wait, and
        the prep/score/place/exchange/merge phase split, plus up to 64
        per-superstep rows. See :mod:`repro_torch.core.profile`."""
        return self.telemetry.get("profile")

    def vertex_assignment(self) -> np.ndarray:
        """A vertex->partition view: the assignment itself for edge-cut
        results, replica *masters* for vertex-cut results."""
        if self.is_vertex_cut:
            return np.asarray(self.edge_partition.masters)
        return self.assignment

    def quality(self) -> dict:
        """Lazily computed + cached quality metrics. Edge-cut results: λ_EC /
        λ_CV / imbalances, scanned on ``device``
        (:func:`repro_torch.graph.metrics.quality_report`). Vertex-cut
        results: replication factor + edge imbalance (host numpy over the
        edge partition)."""
        if self._quality is None:
            if self.is_vertex_cut:
                ep = self.edge_partition
                self._quality = {
                    "kind": "vertex-cut",
                    "k": self.k,
                    "replication_factor": float(ep.replication_factor),
                    "edge_imbalance": float(ep.edge_imbalance()),
                }
            else:
                from repro_torch.graph.metrics import quality_report

                self._quality = {
                    "kind": "edge-cut",
                    **quality_report(self.graph, self.assignment, self.k, self.device),
                }
        return self._quality

    # ------------------------------------------------------------- analytics
    def localized(self) -> LocalizedGraph:
        """The per-device layout of this partition for the analytics engine
        (:func:`repro_torch.analytics.localize`, host numpy), built on first
        call and kept; its host time goes to ``timings["localize_seconds"]``."""
        if self._localized is None:
            from repro_torch.analytics import localize

            t0 = time.perf_counter()
            self._localized = localize(self.graph, self.assignment, self.k)
            self.timings["localize_seconds"] = time.perf_counter() - t0
        return self._localized

    def analytics(
        self,
        program: str = "pagerank",
        iters: int = 30,
        mode: str = "model",
    ) -> dict:
        """Run the paper's analytics study on this partition.

        ``mode="model"``: the reference's cost model, with the reference's
        parameters (edge-cut and vertex-cut results alike); its times are
        modelled, not measured on any device.
        ``mode="simulated"`` (edge-cut results only): run the vertex-program
        engine on ``device``
        (the K devices on the leading axis of one card's arrays) and report
        its halo traffic; ``seconds`` is the wall time of the run, the card
        synchronised before the clock stops. ``values`` is float32[|V|].
        """
        if mode == "model":
            from repro_torch.analytics import workload_cost

            target = self.edge_partition if self.is_vertex_cut else self.assignment
            return {
                "mode": "model",
                "program": program,
                **workload_cost(self.graph, target, self.k, iters),
            }
        if mode != "simulated":
            raise ValueError(f"unknown analytics mode {mode!r}")
        if self.is_vertex_cut:
            raise ValueError(
                "simulated analytics needs a vertex partition; "
                "vertex-cut results only support mode='model'"
            )
        from repro_torch.analytics import PROGRAMS, GraphEngine

        if program not in PROGRAMS:
            raise ValueError(
                f"unknown program {program!r}; expected one of "
                f"{sorted(PROGRAMS)}"
            )
        eng = GraphEngine(self.localized(), PROGRAMS[program](), device=self.device)
        t0 = time.perf_counter()
        values = eng.run_simulated(iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        st = eng.stats(iters)
        return {
            "mode": "simulated",
            "program": program,
            "iters": iters,
            "seconds": seconds,
            "values": values,
            "halo_messages_per_iter": st.true_halo_messages_per_iter,
            "padded_halo_elements_per_iter": st.padded_halo_elements_per_iter,
            "max_local_edges": st.max_local_edges,
            "mean_local_edges": st.mean_local_edges,
        }

    # -------------------------------------------------------------------- db
    def db(
        self,
        workload: str = "ldbc",
        hops: int = 2,
        num_queries: int = 256,
        seed: int = 0,
        degree_biased: bool = True,
        concurrency: int = 24,
        seeds: np.ndarray | None = None,
    ) -> dict:
        """Run the graph-DB workload study (paper Table V) on this partition.

        Pass precomputed query ``seeds`` to reuse one mix across several
        calls (e.g. hops=1 and hops=2 on the same result); otherwise a fresh
        degree-biased LDBC-like mix is drawn from ``seed``.
        """
        from repro_torch.db import QueryEngine, ldbc_query_mix

        if workload != "ldbc":
            raise ValueError(f"unknown db workload {workload!r}; expected 'ldbc'")
        if hops not in (1, 2):
            raise ValueError(f"hops must be 1 or 2, got {hops!r}")
        part = self.vertex_assignment()
        engine = QueryEngine(self.graph, part, self.k)
        if seeds is None:
            seeds = ldbc_query_mix(
                self.graph, num_queries, seed=seed, degree_biased=degree_biased
            )
        else:
            num_queries = len(seeds)
        _, stats = engine.one_hop(seeds) if hops == 1 else engine.two_hop(seeds)
        return {
            "workload": workload,
            "hops": hops,
            "num_queries": num_queries,
            "qps": stats.throughput_qps(concurrency),
            "p99_latency_ms": stats.p99_latency_s() * 1e3,
            "mean_latency_ms": float(stats.latencies_s.mean()) * 1e3,
            "total_rpcs": stats.total_rpcs,
            "total_net_values": stats.total_net_values,
            "total_scanned_edges": stats.total_scanned_edges,
        }

    # ---------------------------------------------------------------- serving
    def serve(
        self,
        replication_budget: float | None = None,
        max_workers: int = 0,
        fanout_cap: int = 64,
        store_results: bool = True,
    ):
        """Stand up a partition-aware query service over this partition
        (its assignment as it stands: nothing is re-partitioned).

        Returns an (unstarted) :class:`repro_torch.serve.graph.GraphService`;
        use it as a context manager or hand it to
        :func:`repro_torch.serve.graph.run_load`, which starts/stops it
        around the load run. ``replication_budget`` defaults to the spec's
        own knob.
        """
        from repro_torch.serve.graph import GraphService

        budget = (
            self.spec.replication_budget
            if replication_budget is None
            else replication_budget
        )
        return GraphService(
            self.graph,
            self.vertex_assignment(),
            self.k,
            replication_budget=budget,
            max_workers=max_workers,
            fanout_cap=fanout_cap,
            store_results=store_results,
        )

    def serve_bench(
        self,
        num_queries: int = 1000,
        concurrency: int = 256,
        mix=None,
        seed: int = 0,
        mode: str = "closed",
        rate_qps: float | None = None,
        replication_budget: float | None = None,
        max_workers: int = 0,
        store_results: bool = False,
    ) -> dict:
        """Partition -> serve -> load-gen in one call; returns the serving
        report as a JSON-ready dict (the CLI ``serve-bench`` payload)."""
        from repro_torch.serve.graph import run_load

        report = run_load(
            self.serve(
                replication_budget=replication_budget,
                max_workers=max_workers,
                store_results=store_results,
            ),
            num_queries=num_queries,
            concurrency=concurrency,
            mix=mix,
            seed=seed,
            mode=mode,
            rate_qps=rate_qps,
        )
        return jsonify(report.to_dict())

    # ----------------------------------------------------------------- report
    def to_report(
        self, include_assignment: bool = False, include_quality: bool = True
    ) -> dict:
        """JSON-serializable structured report (the CLI's output row): the
        reference's keys plus ``device``, where the partition was made.

        ``include_quality=False`` skips the quality metrics, which scan the
        whole edge set - the escape hatch for out-of-core runs where the
        graph deliberately exceeds RAM.
        """
        report = {
            "spec": self.spec.to_dict(),
            "graph": {
                "num_vertices": int(self.graph.num_vertices),
                "num_edges": int(self.graph.num_edges),
            },
            "device": str(self.device),
            "timings": jsonify(self.timings),
            "telemetry": jsonify(self.telemetry),
        }
        if include_quality:
            report["quality"] = jsonify(self.quality())
        if include_assignment:
            report["assignment"] = self.assignment.tolist()
        return report


def jsonify(obj):
    """Recursively convert numpy scalars/arrays, torch tensors and devices
    for ``json.dumps``."""
    if isinstance(obj, dict):
        return {str(key): jsonify(val) for key, val in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(val) for val in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, torch.device):
        return str(obj)
    return obj
