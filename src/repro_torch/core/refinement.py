"""CUTTANA Phase 2: coarsened refinement (paper §III-B).

Port of ``repro.core.refinement``. The sub-partition graph ``W`` (Def. 3) is
built on the device with one ``bincount`` over the CSR entries (one per row
range of a memory-mapped graph) and copied to the host once. The
:class:`Refiner`'s trades are sequential: each move
rewrites O(K') entries of ``M`` and a few segment-tree paths (Theorem 2),
so they stay on the host in numpy, as in the reference:

  * ``W``    - K'xK' weighted sub-partition adjacency (diag zeroed),
  * ``M``    - K'xK matrix, M[i,p] = sum_j W[i,j] * [P'(j) = p],
  * ``DEC``  - DEC[i, dst] = M[i,dst] - M[i,src] (Eq. 9),
  * ``MS``   - for every (src, dst) partition pair, a max-segment-tree over
               the DEC values of sub-partitions currently in ``src``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.external import is_mapped, iter_row_ranges

NEG_INF = -np.inf


def build_subpartition_graph(
    graph: CSRGraph, sub_of: np.ndarray, kp: int, device: torch.device
) -> torch.Tensor:
    """Dense float64[K', K'] sub-partition adjacency on ``device``;
    W[i,j] = #edges between members of S_i and S_j, diagonal zeroed. Counts
    are exact integers in float64, so W equals the reference's. A mapped
    graph is counted in row ranges, each range's rows copied once."""
    sub = torch.from_numpy(np.ascontiguousarray(sub_of, dtype=np.int64)).to(device)
    if is_mapped(graph):
        counts = torch.zeros(kp * kp, dtype=torch.int64, device=sub.device)
        for lo, degs, dst in iter_row_ranges(graph):
            rows = torch.arange(lo, lo + degs.shape[0], dtype=torch.int64, device=sub.device)
            src = torch.repeat_interleave(
                rows, torch.from_numpy(degs).to(sub.device), output_size=dst.shape[0]
            )
            key = sub[src] * kp + sub[torch.from_numpy(dst).to(sub.device).long()]
            counts += torch.bincount(key, minlength=kp * kp)
    else:
        g = graph.to(device)
        key = sub[g.sources()] * kp + sub[g.indices.long()]
        counts = torch.bincount(key, minlength=kp * kp)
        del key
    w = counts.to(torch.float64).reshape(kp, kp)
    w = 0.5 * (w + w.T)  # symmetric storage counted each edge twice -> halve
    w.fill_diagonal_(0.0)
    return w


@dataclasses.dataclass
class RefineStats:
    moves: int = 0
    cut_improvement: float = 0.0
    stopped_reason: str = ""


class Refiner:
    def __init__(
        self,
        w: np.ndarray,
        sub_part: np.ndarray,  # int[K'] -> current partition of each sub-part
        size: np.ndarray,  # float[K'] balance mass of each sub-part
        k: int,
        epsilon: float,
        total_mass: float | None = None,
    ):
        self.kp = w.shape[0]
        self.k = k
        self.w = w
        self.sub_part = sub_part.astype(np.int64).copy()
        self.size = size.astype(np.float64)
        total = float(self.size.sum()) if total_mass is None else total_mass
        self.cap = (1.0 + epsilon) * total / k
        self.part_load = np.bincount(
            self.sub_part, weights=self.size, minlength=k
        ).astype(np.float64)
        onehot = np.zeros((self.kp, k), dtype=np.float64)
        onehot[np.arange(self.kp), self.sub_part] = 1.0
        self.m = w @ onehot  # M[i, p]
        # ------------------------------------------------------ segment trees
        # balance is by mass, not count, so slot capacity is the worst case K'
        self.cap2 = 1 << int(np.ceil(np.log2(max(self.kp, 2))))
        self.tree = np.full((k, k, 2 * self.cap2), NEG_INF, dtype=np.float64)
        self.owner = np.full((k, self.cap2), -1, dtype=np.int64)
        self.slot_of = np.full(self.kp, -1, dtype=np.int64)
        self._free: list[list[int]] = [list(range(self.cap2 - 1, -1, -1)) for _ in range(k)]
        for i in range(self.kp):
            self._alloc_slot(i, int(self.sub_part[i]))
        for q in range(k):
            members = np.flatnonzero(self.sub_part == q)
            if members.size:
                self._write_entries_group(members, q)

    # ------------------------------------------------------------- slot mgmt
    def _alloc_slot(self, i: int, p: int) -> None:
        slot = self._free[p].pop()
        self.slot_of[i] = slot
        self.owner[p, slot] = i

    def _release_slot(self, i: int, p: int) -> None:
        slot = int(self.slot_of[i])
        self.owner[p, slot] = -1
        self._free[p].append(slot)
        # clear this slot's leaf across every (p, dst) tree, one repair pass
        self.tree[p, :, self.cap2 + slot] = NEG_INF
        self._repair_levels(p, slice(None), self.slot_of[i : i + 1])

    # ------------------------------------------------------------- tree ops
    def _repair_levels(self, src: int, dst_idx, slots: np.ndarray) -> None:
        """Recompute the internal max nodes above ``slots`` in the
        ``(src, dst)`` trees selected by ``dst_idx`` (a slice or an index
        array), one K-wide ``maximum`` per level."""
        t = self.tree[src]
        nodes = np.unique((np.asarray(slots, dtype=np.int64) + self.cap2) >> 1)
        while True:
            if isinstance(dst_idx, slice):
                t[dst_idx, nodes] = np.maximum(
                    t[dst_idx, 2 * nodes], t[dst_idx, 2 * nodes + 1]
                )
            else:
                t[np.ix_(dst_idx, nodes)] = np.maximum(
                    t[np.ix_(dst_idx, 2 * nodes)], t[np.ix_(dst_idx, 2 * nodes + 1)]
                )
            if nodes[0] == 1:  # perfect tree: every leaf reaches the root together
                return
            nodes = np.unique(nodes >> 1)

    def _write_entries(self, i: int) -> None:
        """(Re)write DEC entries of sub-partition ``i`` for all destinations."""
        p = int(self.sub_part[i])
        slot = int(self.slot_of[i])
        col = self.m[i] - self.m[i, p]
        col[p] = NEG_INF  # own partition is never a trade destination
        self.tree[p, :, self.cap2 + slot] = col
        self._repair_levels(p, slice(None), self.slot_of[i : i + 1])

    def _write_entries_group(self, members: np.ndarray, q: int) -> None:
        """Batched :meth:`_write_entries` for sub-partitions all living in
        ``q``: one [K, n] leaf write + one repair pass."""
        slots = self.slot_of[members]
        vals = self.m[members] - self.m[members, q][:, None]  # [n, K]
        vals[:, q] = NEG_INF
        self.tree[q][:, self.cap2 + slots] = vals.T
        self._repair_levels(q, slice(None), slots)

    def _write_pair_group(self, members: np.ndarray, q: int, src: int, dst: int) -> None:
        """Theorem 2 update for neighbours whose home partition ``q`` is
        uninvolved in the move: only their (q, src) and (q, dst) entries
        changed."""
        slots = self.slot_of[members]
        base = self.m[members, q]
        t = self.tree[q]
        t[src, self.cap2 + slots] = self.m[members, src] - base
        t[dst, self.cap2 + slots] = self.m[members, dst] - base
        self._repair_levels(q, np.asarray([src, dst]), slots)

    def _best_feasible(self, src: int, dst: int, floor: float) -> tuple[int, float] | None:
        """Best DEC > floor among feasible moves src->dst (pruned descent)."""
        t = self.tree[src, dst]
        if t[1] <= floor:
            return None
        room = self.cap - self.part_load[dst]
        best_slot, best_val = -1, floor
        stack = [1]
        while stack:
            node = stack.pop()
            if t[node] <= best_val:
                continue
            if node >= self.cap2:  # leaf
                slot = node - self.cap2
                i = self.owner[src, slot]
                if i >= 0 and self.size[i] <= room + 1e-9:
                    best_slot, best_val = slot, t[node]
            else:
                # visit the larger child first for tighter pruning
                l, r = 2 * node, 2 * node + 1
                if t[l] >= t[r]:
                    stack.extend((r, l))
                else:
                    stack.extend((l, r))
        return None if best_slot < 0 else (best_slot, best_val)

    # ------------------------------------------------------------- main API
    def best_move(self, thresh: float = 0.0) -> tuple[int, int, float] | None:
        """Globally best feasible trade: (sub_part_id, dst, dec) or None."""
        best: tuple[int, int, float] | None = None
        floor = thresh
        for src in range(self.k):
            for dst in range(self.k):
                if src == dst:
                    continue
                got = self._best_feasible(src, dst, floor)
                if got is not None:
                    slot, val = got
                    best = (int(self.owner[src, slot]), dst, float(val))
                    floor = val
        return best

    def apply_move(self, i: int, dst: int) -> float:
        """Apply trade <S_i, dst>; returns the edge-cut decrease."""
        src = int(self.sub_part[i])
        dec = float(self.m[i, dst] - self.m[i, src])
        nbrs = np.flatnonzero(self.w[i])
        wvals = self.w[i, nbrs]
        # --- M updates for neighbours (Eq. 10 in M-form)
        self.m[nbrs, src] -= wvals
        self.m[nbrs, dst] += wvals
        # --- move i itself
        self._release_slot(i, src)
        self.sub_part[i] = dst
        self.part_load[src] -= self.size[i]
        self.part_load[dst] += self.size[i]
        self._alloc_slot(i, dst)
        self._write_entries(i)
        # --- Theorem 2 updates for neighbours, batched per home partition
        if nbrs.size:
            qs = self.sub_part[nbrs]
            for q in np.unique(qs).tolist():
                members = nbrs[qs == q]
                if q == src or q == dst:
                    # base m[j, q] changed: every destination entry is dirty
                    self._write_entries_group(members, int(q))
                else:
                    self._write_pair_group(members, int(q), src, dst)
        return dec

    def refine(
        self, thresh: float = 0.0, max_moves: int | None = None
    ) -> RefineStats:
        stats = RefineStats()
        while True:
            if max_moves is not None and stats.moves >= max_moves:
                stats.stopped_reason = "max_moves"
                return stats
            mv = self.best_move(thresh)
            if mv is None:
                stats.stopped_reason = "maximal" if thresh <= 0 else "thresh"
                return stats
            i, dst, _ = mv
            stats.moves += 1
            stats.cut_improvement += self.apply_move(i, dst)

    # ------------------------------------------------------------- debugging
    def current_cut(self) -> float:
        """Edge-cut of the coarsened graph (Prop. 1)."""
        same = self.sub_part[:, None] == self.sub_part[None, :]
        return float(self.w[~same].sum() / 2.0)

    def check_invariants(self) -> None:
        onehot = np.zeros((self.kp, self.k))
        onehot[np.arange(self.kp), self.sub_part] = 1.0
        np.testing.assert_allclose(self.m, self.w @ onehot, atol=1e-6)
        loads = np.bincount(self.sub_part, weights=self.size, minlength=self.k)
        np.testing.assert_allclose(self.part_load, loads, atol=1e-6)
        for src in range(self.k):
            for dst in range(self.k):
                if src == dst:
                    continue
                t = self.tree[src, dst]
                for slot in range(self.cap2):
                    i = self.owner[src, slot]
                    expect = (
                        self.m[i, dst] - self.m[i, src] if i >= 0 else NEG_INF
                    )
                    got = t[self.cap2 + slot]
                    if i >= 0:
                        assert abs(got - expect) < 1e-6, (src, dst, slot, got, expect)
                    else:
                        assert got == NEG_INF


# --------------------------------------------------------------------- swaps
def best_swap(r: Refiner) -> tuple[int, int, float] | None:
    """Paper §VI future work: when single trades are balance-blocked, a
    *pairwise swap* <S_i in V_a, S_j in V_b> can still improve quality while
    keeping both partitions within capacity. Returns the best (i, j, gain)
    with gain = DEC_i(a->b) + DEC_j(b->a) - 2*W(S_i,S_j), or None.

    The reference scans the pairs in a Python loop (``i`` ascending, ``j``
    over ``flatnonzero(w[i])`` ascending, ``j > i``) and keeps a pair only
    when its gain is strictly larger; here every pair is formed at once in
    that same row-major order with the same double operations, and
    ``argmax`` picks the first maximum, so ties pick the same pair."""
    i, j = np.nonzero(r.w)  # row-major: i ascending, then j ascending
    keep = j > i
    i, j = i[keep], j[keep]
    a, b = r.sub_part[i], r.sub_part[j]
    keep = a != b
    i, j, a, b = i[keep], j[keep], a[keep], b[keep]
    # they stop being cut towards each other... twice-counted
    gain = (r.m[i, b] - r.m[i, a]) + (r.m[j, a] - r.m[j, b]) - 2.0 * r.w[i, j]
    # balance: dest gains size[x] - size[y]
    ok = (
        (gain > 1e-9)
        & ~(r.part_load[b] + r.size[i] - r.size[j] > r.cap + 1e-9)
        & ~(r.part_load[a] + r.size[j] - r.size[i] > r.cap + 1e-9)
    )
    if not ok.any():
        return None
    gain = gain[ok]
    best = int(np.argmax(gain))
    return int(i[ok][best]), int(j[ok][best]), float(gain[best])


def refine_with_swaps(r: Refiner, thresh: float = 0.0,
                      max_rounds: int = 50) -> dict:
    """Alternate greedy single trades with pairwise swaps until neither
    improves (a strictly larger move class than the paper's maximality)."""
    moves = swaps = 0
    improvement = 0.0
    for _ in range(max_rounds):
        stats = r.refine(thresh=thresh)
        moves += stats.moves
        improvement += stats.cut_improvement
        sw = best_swap(r)
        if sw is None:
            break
        i, j, gain = sw
        a, b = int(r.sub_part[i]), int(r.sub_part[j])
        got = r.apply_move(i, b) + r.apply_move(j, a)
        improvement += got
        swaps += 1
    return {"moves": moves, "swaps": swaps, "improvement": improvement}
