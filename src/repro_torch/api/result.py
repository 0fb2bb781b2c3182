"""``PartitionResult``: the result of a spec run (port of
``repro.api.result``: :meth:`PartitionResult.quality`, the parallel engine's
:attr:`PartitionResult.profile`, and the analytics study
:meth:`PartitionResult.analytics`)."""
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

__all__ = ["PartitionResult"]


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
