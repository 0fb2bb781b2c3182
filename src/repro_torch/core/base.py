"""Shared machinery for streaming vertex partitioners (paper §II, Eq. 5/7).

Port of ``repro.core.base``. The running state stays on the host in numpy:
placements are sequential and data-dependent. :class:`PartitionState` adds
one device tensor, ``part_of_dev``, a mirror of ``part_of`` that the
partition-score kernel reads; the engine keeps it in step (see
:mod:`repro_torch.core.engine`).

Balance modes:
  * ``"vertex"``  - Eq. 1: |V_i| <= (1+eps) |V|/K
  * ``"edge"``    - Eq. 2: Σ_{v∈V_i} |N(v)| <= (1+eps) 2|E|/K
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph

UNASSIGNED = -1


@dataclasses.dataclass
class PartitionState:
    """Mutable running state shared by all streaming partitioners."""

    k: int
    num_vertices: int
    total_degree: int  # == 2|E|
    epsilon: float
    balance_mode: str  # "vertex" | "edge"
    part_of: np.ndarray  # int32[|V|], UNASSIGNED until placed
    v_counts: np.ndarray  # float64[k]  vertices per partition
    e_counts: np.ndarray  # float64[k]  degree mass per partition
    rng: np.random.Generator  # tie-break draws, same stream as the reference
    part_of_dev: torch.Tensor  # int32[|V|] device mirror of part_of

    @staticmethod
    def create(
        graph: CSRGraph,
        k: int,
        epsilon: float,
        balance_mode: str,
        seed: int = 0,
        *,
        device: torch.device,
    ) -> "PartitionState":
        part_of = np.full(graph.num_vertices, UNASSIGNED, dtype=np.int32)
        return PartitionState.from_arrays(
            part_of,
            np.zeros(k, dtype=np.float64),
            np.zeros(k, dtype=np.float64),
            k=k,
            total_degree=int(graph.indices.shape[0]),
            epsilon=epsilon,
            balance_mode=balance_mode,
            seed=seed,
            device=device,
        )

    @staticmethod
    def from_arrays(
        part_of: np.ndarray,
        v_counts: np.ndarray,
        e_counts: np.ndarray,
        *,
        k: int,
        total_degree: int,
        epsilon: float,
        balance_mode: str,
        seed: int,
        device: torch.device,
    ) -> "PartitionState":
        if balance_mode not in ("vertex", "edge"):
            raise ValueError(f"unknown balance mode {balance_mode}")
        part_of = np.array(part_of, dtype=np.int32)
        return PartitionState(
            k=k,
            num_vertices=int(part_of.shape[0]),
            total_degree=int(total_degree),
            epsilon=epsilon,
            balance_mode=balance_mode,
            part_of=part_of,
            v_counts=np.array(v_counts, dtype=np.float64),
            e_counts=np.array(e_counts, dtype=np.float64),
            rng=np.random.default_rng(seed),
            # a copy even on the CPU, so a stale mirror shows in CPU runs too
            part_of_dev=torch.from_numpy(part_of.copy()).to(device),
        )

    # ---------------------------------------------------------------- mirror
    @property
    def device(self) -> torch.device:
        return self.part_of_dev.device

    def sync_mirror(self) -> None:
        """Copy the whole host ``part_of`` into the device mirror."""
        self.part_of_dev.copy_(torch.from_numpy(self.part_of))

    # -------------------------------------------------------------- capacity
    @property
    def vertex_capacity(self) -> float:
        return (1.0 + self.epsilon) * self.num_vertices / self.k

    @property
    def edge_capacity(self) -> float:
        return (1.0 + self.epsilon) * self.total_degree / self.k

    def would_overflow(self, deg: int) -> np.ndarray:
        """bool[k]: placing a degree-``deg`` vertex would break the condition."""
        if self.balance_mode == "vertex":
            return self.v_counts + 1 > self.vertex_capacity
        return self.e_counts + deg > self.edge_capacity

    # ------------------------------------------------------------- mutation
    def assign(self, v: int, p: int, deg: int) -> None:
        self.part_of[v] = p
        self.v_counts[p] += 1
        self.e_counts[p] += deg

    # ------------------------------------------------------------- helpers
    def neighbor_histogram(self, nbrs: np.ndarray) -> np.ndarray:
        """float64[k]: count of already-assigned neighbours per partition."""
        assigned = self.part_of[nbrs]
        assigned = assigned[assigned != UNASSIGNED]
        if assigned.size == 0:
            return np.zeros(self.k, dtype=np.float64)
        return np.bincount(assigned, minlength=self.k).astype(np.float64)

    def argmax_tiebreak(self, scores: np.ndarray, allowed: np.ndarray) -> int:
        """argmax over allowed partitions with seeded random tie-breaking."""
        masked = np.where(allowed, scores, -np.inf)
        best = masked.max()
        if not np.isfinite(best):
            # every partition is at capacity - fall back to least loaded
            loads = self.v_counts if self.balance_mode == "vertex" else self.e_counts
            return int(loads.argmin())
        ties = np.flatnonzero(masked >= best - 1e-12)
        if ties.size == 1:
            return int(ties[0])
        return int(ties[self.rng.integers(ties.size)])


@dataclasses.dataclass(frozen=True)
class FennelParams:
    """FENNEL scoring (paper Eq. 7). gamma/alpha per Tsourakakis et al."""

    gamma: float = 1.5
    alpha_scale: float = 1.0  # multiplier on the canonical alpha
    hybrid: bool = True  # PowerLyra-style edge term in the penalty (Eq. 7)


def make_fennel_score(
    graph: CSRGraph, k: int, params: FennelParams, balance_mode: str
) -> Callable[[PartitionState, np.ndarray], np.ndarray]:
    """Returns score(state, hist) -> float64[k] implementing Eq. 7.

    score_i = hist_i - alpha*gamma * size_i^(gamma-1)
    where size_i = |V_i|                      (vertex mode, classic FENNEL)
          size_i = (|V_i| + mu * E_i) / 2     (edge mode, PowerLyra hybrid;
                                               mu = |V| / 2|E|)
    """
    n = max(graph.num_vertices, 1)
    m = max(graph.num_edges, 1)
    alpha = params.alpha_scale * np.sqrt(k) * m / (n**1.5)
    mu = n / max(graph.indices.shape[0], 1)  # |V| / 2|E|
    gamma = params.gamma
    use_hybrid = params.hybrid and balance_mode == "edge"

    def score(state: PartitionState, hist: np.ndarray) -> np.ndarray:
        if use_hybrid:
            size = 0.5 * (state.v_counts + mu * state.e_counts)
        else:
            size = state.v_counts
        return hist - alpha * gamma * np.power(np.maximum(size, 0.0), gamma - 1.0)

    return score


def finalize(state: PartitionState) -> np.ndarray:
    """All vertices must be assigned; returns int32[|V|]."""
    if (state.part_of == UNASSIGNED).any():
        raise RuntimeError("unassigned vertices remain")
    return state.part_of.copy()
