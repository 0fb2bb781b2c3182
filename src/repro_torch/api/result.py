"""``PartitionResult``: the result of a spec run (port of
``repro.api.result``, limited to :meth:`PartitionResult.quality`)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.spec import PartitionSpec
from repro_torch.graph.csr import CSRGraph

__all__ = ["PartitionResult"]


@dataclasses.dataclass(eq=False)  # ndarray fields make generated __eq__ raise
class PartitionResult:
    """``assignment`` is the vertex->partition array (int32[|V|]) the
    algorithm returned; ``device`` is where the run and the quality scans
    execute."""

    spec: PartitionSpec
    graph: CSRGraph
    assignment: np.ndarray
    device: torch.device
    timings: dict = dataclasses.field(default_factory=dict)
    telemetry: dict = dataclasses.field(default_factory=dict)
    _quality: dict | None = dataclasses.field(default=None, repr=False)

    @property
    def k(self) -> int:
        return self.spec.k

    def quality(self) -> dict:
        """Lazily computed + cached λ_EC / λ_CV / imbalances, scanned on
        ``device`` (:func:`repro_torch.graph.metrics.quality_report`)."""
        if self._quality is None:
            from repro_torch.graph.metrics import quality_report

            self._quality = {
                "kind": "edge-cut",
                **quality_report(self.graph, self.assignment, self.k, self.device),
            }
        return self._quality
