"""Sub-partitioning (paper §III-B, Def. 2): assigning each vertex to one of
``S = K'/K`` sub-partitions *inside* its chosen partition, during phase 1.

Port of ``repro.core.subpartition`` (the sequential :meth:`assign`; the
superstep variant arrives with the parallel engine). It runs on the host,
one vertex at a time, in the order the policy places vertices, and draws its
ties from the same ``default_rng(seed + 7)`` as the reference.

Global sub-partition id of (partition p, local slot s) is ``p * S + s``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.base import UNASSIGNED
from repro_torch.graph.csr import CSRGraph


class SubPartitioner:
    def __init__(
        self,
        graph: CSRGraph,
        k: int,
        subparts_per_partition: int,
        epsilon: float = 0.10,
        balance_mode: str = "edge",
        seed: int = 0,
    ):
        self.k = k
        self.s = int(subparts_per_partition)
        self.kp = k * self.s  # K'
        self.balance_mode = balance_mode
        n = max(graph.num_vertices, 1)
        self.sub_of = np.full(graph.num_vertices, UNASSIGNED, dtype=np.int32)
        self.sub_v_counts = np.zeros(self.kp, dtype=np.float64)
        self.sub_e_counts = np.zeros(self.kp, dtype=np.float64)
        # greedy affinity with a weak linear size penalty plus a HARD
        # capacity: sub-partitions must stay near-equal-sized (Lemma 1)
        self.mu = n / max(graph.indices.shape[0], 1)
        self.v_cap = (1.0 + epsilon) * n / self.kp
        self.e_cap = (1.0 + epsilon) * graph.indices.shape[0] / self.kp
        self.rng = np.random.default_rng(seed + 7)

    def assign(self, v: int, p: int, nbrs: np.ndarray, deg: int) -> int:
        """Choose a sub-partition for ``v`` inside partition ``p``."""
        lo, hi = p * self.s, (p + 1) * self.s
        sub_assigned = self.sub_of[nbrs]
        sub_assigned = sub_assigned[(sub_assigned >= lo) & (sub_assigned < hi)]
        hist = np.bincount(sub_assigned - lo, minlength=self.s).astype(np.float64)
        if self.balance_mode == "edge":
            size = 0.5 * (
                self.sub_v_counts[lo:hi] + self.mu * self.sub_e_counts[lo:hi]
            )
            cap = 0.5 * (self.v_cap + self.mu * self.e_cap)
            over = self.sub_e_counts[lo:hi] + deg > self.e_cap
        else:
            size = self.sub_v_counts[lo:hi]
            cap = self.v_cap
            over = self.sub_v_counts[lo:hi] + 1 > self.v_cap
        scores = hist - 0.125 * (size / max(cap, 1e-9))
        masked = np.where(over, -np.inf, scores)
        best = masked.max()
        if not np.isfinite(best):
            local = int(self.sub_e_counts[lo:hi].argmin())
        else:
            ties = np.flatnonzero(masked >= best - 1e-12)
            local = int(ties[0] if ties.size == 1 else ties[self.rng.integers(ties.size)])
        sp = lo + local
        self.sub_of[v] = sp
        self.sub_v_counts[sp] += 1
        self.sub_e_counts[sp] += deg
        return sp
