"""Sub-partitioning (paper §III-B, Def. 2): assigning each vertex to one of
``S = K'/K`` sub-partitions *inside* its chosen partition, during phase 1.

Port of ``repro.core.subpartition``. It runs on the host in numpy:
:meth:`assign` one vertex at a time, in the order the sequential policies
place vertices, drawing its ties from the same ``default_rng(seed + 7)`` as
the reference; :meth:`assign_superstep` a committed superstep of the
parallel engine at a time, as a pool task, with ties to the lowest
sub-slot.

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

    def assign_superstep(
        self,
        vs: np.ndarray,  # int64[total] vertices placed this superstep
        ps: np.ndarray,  # int64[total] their committed partitions
        degs: np.ndarray,  # int64[total]
        rows: np.ndarray,  # int64[nnz] flat expansion, sorted ascending
        cols: np.ndarray,  # int64[nnz] neighbour ids
        wave: int = 128,
    ) -> None:
        """Vectorised sub-placement for one committed superstep of the
        parallel engine (the per-vertex :meth:`assign` numpy dispatch was
        the dominant phase-1 cost there).

        ``wave`` vertices are scored at a time: each wave's neighbour ->
        sub-partition histograms are built from the LIVE ``sub_of`` (so
        earlier waves of the same superstep are visible exactly - no
        correction pass needed), sizes are frozen within the wave and a
        bincount projection catches would-be capacity overshoots, which are
        replayed per vertex. Ties break to the lowest sub-slot: like the
        shard placement waves, deterministic without rng, so the parallel
        engine's output is independent of worker count. Runs as a chained
        pool task - it must not read partition state beyond its arguments.
        """
        total = int(vs.shape[0])
        if total == 0:
            return
        s = self.s
        edge_mode = self.balance_mode == "edge"
        cap = (
            0.5 * (self.v_cap + self.mu * self.e_cap) if edge_mode else self.v_cap
        )
        cap = max(cap, 1e-9)
        sub_v, sub_e = self.sub_v_counts, self.sub_e_counts
        V2 = sub_v.reshape(self.k, s)
        E2 = sub_e.reshape(self.k, s)
        degf = degs.astype(np.float64)
        ps = np.asarray(ps, dtype=np.int64)
        for g0 in range(0, total, int(wave)):
            g1 = min(g0 + int(wave), total)
            g = g1 - g0
            a, b = np.searchsorted(rows, (g0, g1))
            r = rows[a:b] - g0
            sub_nb = self.sub_of[cols[a:b]].astype(np.int64)
            p_r = ps[rows[a:b]]
            same = (sub_nb >= p_r * s) & (sub_nb < (p_r + 1) * s)
            hist = (
                np.bincount(
                    r[same] * s + (sub_nb[same] - p_r[same] * s), minlength=g * s
                )
                .astype(np.float64)
                .reshape(g, s)
            )
            pw = ps[g0:g1]
            dw = degf[g0:g1]
            bv = V2[pw]
            be = E2[pw]
            if edge_mode:
                size = 0.5 * (bv + self.mu * be)
                over = be + dw[:, None] > self.e_cap
            else:
                size = bv
                over = bv + 1.0 > self.v_cap
            masked = np.where(over, -np.inf, hist - 0.125 * (size / cap))
            local = masked.argmax(axis=1).astype(np.int64)
            best = masked[np.arange(g), local]
            fb = ~(best > -np.inf)
            if fb.any():
                local[fb] = be[fb].argmin(axis=1)
            sp = pw * s + local
            addv = np.bincount(sp, minlength=self.kp).astype(np.float64)
            adde = np.bincount(sp, weights=dw, minlength=self.kp)
            over_p = (
                sub_e + adde > self.e_cap if edge_mode else sub_v + addv > self.v_cap
            )
            nf = np.flatnonzero(~fb)
            if nf.size and over_p[sp[nf]].any():
                # rare: the wave would overshoot a sub-partition's hard cap -
                # replay per vertex against live counts (frozen affinities)
                for i in range(g):
                    p = int(pw[i])
                    lo = p * s
                    ve = sub_v[lo : lo + s]
                    ee = sub_e[lo : lo + s]
                    if edge_mode:
                        size_i = 0.5 * (ve + self.mu * ee)
                        over_i = ee + dw[i] > self.e_cap
                    else:
                        size_i = ve
                        over_i = ve + 1.0 > self.v_cap
                    m = np.where(over_i, -np.inf, hist[i] - 0.125 * (size_i / cap))
                    b_ = m.max()
                    li = int(m.argmax()) if b_ > -np.inf else int(ee.argmin())
                    spi = lo + li
                    sp[i] = spi
                    sub_v[spi] += 1.0
                    sub_e[spi] += dw[i]
            else:
                sub_v += addv
                sub_e += adde
            self.sub_of[vs[g0:g1]] = sp


def phase2_subpartitioner(
    graph: CSRGraph,
    k: int,
    subparts_per_partition: int,
    refine: bool,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    seed: int = 0,
) -> SubPartitioner | None:
    """The sub-placement a CUTTANA run builds in phase 1 for phase 2 to
    refine, or None when the run does not refine. It feeds only phase 2 and
    draws its ties from its own generator, so a run without refinement
    skips it: the same assignment without a K'/K-wide host update per
    placed vertex."""
    if not refine:
        return None
    return SubPartitioner(
        graph, k, subparts_per_partition,
        epsilon=max(epsilon, 0.10), balance_mode=balance_mode, seed=seed,
    )
