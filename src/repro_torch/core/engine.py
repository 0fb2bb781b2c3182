"""Batched streaming engine: one scoring core for FENNEL, LDG and CUTTANA.

Port of the sequential half of ``repro.core.engine`` (scorers,
:class:`EngineConfig`, :class:`ImmediatePolicy`, :class:`BufferedPolicy`,
:class:`StreamEngine`); the sharded policies arrive with the parallel
engine.

The stream is consumed in chunks of ``C`` vertices. For the immediate
policy, all ``C x K`` assigned-neighbour histograms of a chunk come from ONE
call of the partition-score kernel (:mod:`repro_torch.kernels.partition_score`),
which reads the chunk's CSR rows and the ``part_of`` mirror directly on the
device. A host loop then places the chunk's vertices in stream order,
correcting the histograms for in-chunk neighbours, so assignments are
bit-identical to the reference.

What lives where, and why:

* On the device: the CSR ``indptr``/``indices``, the stream order, the
  ``part_of`` mirror (:attr:`PartitionState.part_of_dev`) and the kernel's
  inputs and outputs. After each chunk's placements are flushed to the host
  state, the same assignments are written into the mirror before the next
  launch. The buffered policy places one vertex at a time on the host and
  syncs the whole mirror once when it ends.
* On the host, in numpy as in the reference: the per-vertex placement loops
  (:meth:`ImmediatePolicy.run`, :meth:`BufferedPolicy.run`), the priority
  buffer and its Eq. 6 priority, the sub-partitioner, and the tie-break
  generator. Each placement depends on the one before it; a torch op per
  vertex would cost a launch plus a device-to-host sync per vertex, 10-100x
  the numpy cost.

On the CPU (``device="cpu"``) the same code runs with CPU tensors, and the
kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.base import FennelParams, PartitionState
from repro_torch.core.buffer import PriorityBuffer
from repro_torch.core.priority import BufferStats, make_priority
from repro_torch.core.subpartition import SubPartitioner
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.stream import stream_order
from repro_torch.kernels.partition_score.ops import fennel_scores_gather

__all__ = [
    "FennelScorer",
    "LDGScorer",
    "ImmediatePolicy",
    "BufferedPolicy",
    "EngineConfig",
    "StreamEngine",
]


# ------------------------------------------------------------------ scorers
class FennelScorer:
    """FENNEL Eq. 7: ``hist_i - alpha*gamma*size_i^(gamma-1)`` with
    ``size_i = |V_i|`` (vertex mode) or the PowerLyra hybrid mass
    ``(|V_i| + mu*E_i)/2`` (edge mode, ``params.hybrid``). The K-wide
    penalty is cached and only the assigned partition's entry is recomputed
    per placement."""

    def __init__(
        self,
        graph: CSRGraph,
        k: int,
        params: FennelParams | None = None,
        balance_mode: str = "vertex",
    ):
        params = params or FennelParams()
        n = max(graph.num_vertices, 1)
        m = max(graph.num_edges, 1)
        self.alpha = params.alpha_scale * np.sqrt(k) * m / (n**1.5)
        self.gamma = params.gamma
        self.mu = n / max(graph.indices.shape[0], 1)
        self.hybrid = params.hybrid and balance_mode == "edge"
        self._penalty: np.ndarray | None = None
        self._ag = float(self.alpha * self.gamma)
        self._gm1 = self.gamma - 1.0

    def _sizes(self, state: PartitionState):
        if self.hybrid:
            return 0.5 * (state.v_counts + self.mu * state.e_counts)
        return state.v_counts

    def begin(self, state: PartitionState) -> None:
        self._penalty = self.alpha * self.gamma * np.power(
            np.maximum(self._sizes(state), 0.0), self.gamma - 1.0
        )

    def scores(self, state: PartitionState, hist: np.ndarray) -> np.ndarray:
        return hist - self._penalty

    def on_assign(self, state: PartitionState, p: int, deg: int) -> None:
        if self.hybrid:
            size = 0.5 * (state.v_counts[p] + self.mu * state.e_counts[p])
        else:
            size = state.v_counts[p]
        self._penalty[p] = self.alpha * self.gamma * np.power(
            np.maximum(size, 0.0), self.gamma - 1.0
        )

    # ------------------------------------------------------ affine fast path
    def affine(self, state: PartitionState):
        """scores == hist * mul + add (mul None => 1). See ImmediatePolicy."""
        self.begin(state)
        return None, -self._penalty

    def affine_update(self, v_p: float, e_p: float):
        """New (mul_p, add_p) after partition p's counts became (v_p, e_p).
        Pure-python IEEE doubles: the same values as the numpy path
        (``x ** y`` and ``np.power`` both call libm ``pow``)."""
        if self.hybrid:
            size = 0.5 * (v_p + self.mu * e_p)
        else:
            size = v_p
        if size < 0.0:
            size = 0.0
        return None, -(self._ag * size**self._gm1)


class LDGScorer:
    """Linear Deterministic Greedy: ``hist_i * max(1 - size_i/C, 0)`` with a
    tiny negative load term for least-loaded tie-breaking."""

    def __init__(self, graph: CSRGraph, k: int, balance_mode: str = "vertex"):
        self.balance_mode = balance_mode
        self._factor: np.ndarray | None = None
        self._cap = 0.0

    def _loads(self, state: PartitionState) -> np.ndarray:
        return state.v_counts if self.balance_mode == "vertex" else state.e_counts

    def begin(self, state: PartitionState) -> None:
        self._cap = (
            state.vertex_capacity
            if self.balance_mode == "vertex"
            else state.edge_capacity
        )
        self._factor = np.maximum(1.0 - self._loads(state) / self._cap, 0.0)

    def scores(self, state: PartitionState, hist: np.ndarray) -> np.ndarray:
        return hist * self._factor - 1e-9 * self._loads(state)

    def on_assign(self, state: PartitionState, p: int, deg: int) -> None:
        self._factor[p] = np.maximum(1.0 - self._loads(state)[p] / self._cap, 0.0)

    # ------------------------------------------------------ affine fast path
    def affine(self, state: PartitionState):
        self.begin(state)
        return self._factor, -(1e-9 * self._loads(state))

    def affine_update(self, v_p: float, e_p: float):
        lp = v_p if self.balance_mode == "vertex" else e_p
        if self._cap == 0.0:
            # edgeless graph in edge mode: numpy's 0/0 gives nan, which sinks
            # every score and triggers the least-loaded fallback; plain python
            # would raise instead, so reproduce the nan path explicitly
            return float("nan"), -(1e-9 * lp)
        f = 1.0 - lp / self._cap
        if f < 0.0:
            f = 0.0
        return f, -(1e-9 * lp)


# ------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Chunking knobs for the scoring core.

    ``prefetch`` is the reference's decode-ahead switch for out-of-core
    graphs: for a resident graph ``"auto"`` and ``"off"`` both stream
    synchronously; ``"on"`` needs an out-of-core graph and raises until the
    port has one."""

    chunk: int = 512
    prefetch: str = "auto"

    def __post_init__(self) -> None:
        if self.prefetch not in ("auto", "on", "off"):
            raise ValueError(
                f'prefetch must be "auto", "on" or "off", got {self.prefetch!r}'
            )
        if self.prefetch == "on":
            raise ValueError(
                'prefetch="on" decodes an out-of-core graph ahead of the stream; '
                "out-of-core graphs arrive with slice 4 of the port"
            )
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")


# ----------------------------------------------------------------- policies
class ImmediatePolicy:
    """Place every stream vertex as soon as it arrives (FENNEL / LDG /
    CUTTANA without its buffer), scoring each chunk with one kernel call."""

    def run(self, eng: "StreamEngine") -> None:
        """Host loop for scorers with the affine contract
        ``scores == hist * mul + add``. The K-wide selection runs in plain
        Python over lists (for K <= a few hundred, numpy dispatch overhead
        dwarfs the arithmetic); the numpy state and the device mirror are
        written once per chunk. Every operation is the same IEEE double
        computation as the reference, so results are bit-identical."""
        state = eng.state
        scorer = eng.scorer
        subp = eng.subp
        v_counts, e_counts = state.v_counts, state.e_counts
        k = state.k
        krange = range(k)
        rng = state.rng
        vertex_mode = state.balance_mode == "vertex"
        cap = state.vertex_capacity if vertex_mode else state.edge_capacity
        neg_inf = float("-inf")
        sc = [neg_inf] * k  # per-vertex score buffer (neg_inf == disallowed)
        for start, batch, degs, expanded in _iter_chunk_expansions(eng):
            nbr_views = _chunk_views(expanded[1], degs) if subp is not None else None
            H, corr = eng.chunk_histograms(start, batch, expanded)
            bl = batch.tolist()
            dl = degs.tolist()
            assigned = [0] * len(bl)
            mul_a, add_a = scorer.affine(state)
            mul = None if mul_a is None else mul_a.tolist()
            add = add_a.tolist()
            v_list = v_counts.tolist()
            e_list = e_counts.tolist()
            load = v_list if vertex_mode else e_list
            dst, starts = corr
            for i in range(len(bl)):
                v, deg = bl[i], dl[i]
                row = H[i]
                inc = 1 if vertex_mode else deg
                best = neg_inf
                if mul is None:
                    for p in krange:
                        if load[p] + inc > cap:
                            sc[p] = neg_inf
                            continue
                        s = row[p] + add[p]
                        sc[p] = s
                        if s > best:
                            best = s
                else:
                    for p in krange:
                        if load[p] + inc > cap:
                            sc[p] = neg_inf
                            continue
                        s = row[p] * mul[p] + add[p]
                        sc[p] = s
                        if s > best:
                            best = s
                if best == neg_inf:
                    # every partition at capacity - least-loaded fallback,
                    # same rule as PartitionState.argmax_tiebreak
                    p = load.index(min(load))
                else:
                    thr = best - 1e-12
                    ties = [p for p in krange if sc[p] >= thr]
                    p = ties[0] if len(ties) == 1 else int(ties[rng.integers(len(ties))])
                assigned[i] = p
                v_list[p] += 1
                e_list[p] += deg
                u = scorer.affine_update(v_list[p], e_list[p])
                if mul is not None:
                    mul[p] = u[0]
                add[p] = u[1]
                if subp is not None:
                    subp.assign(v, p, nbr_views[i], deg)
                for j in dst[starts[i] : starts[i + 1]]:
                    H[j][p] += 1.0
            # flush the chunk into the numpy state and the device mirror
            state.part_of[batch] = assigned
            v_counts[:] = v_list
            e_counts[:] = e_list
            eng.flush_chunk(start, batch.shape[0], assigned)


class BufferedPolicy:
    """CUTTANA Algorithm 1: vertices with degree >= D_max are placed
    immediately (Thm. 1); the rest enter the bounded priority buffer; on
    overflow the best-scored vertex is evicted and placed; placements bump
    buffered neighbours (vectorised through ``notify_many``) and fully-known
    vertices cascade out immediately. Placement order is data-dependent, so
    each vertex is scored on the host (:meth:`StreamEngine.place`)."""

    def __init__(
        self,
        max_qsize: int,
        d_max: int,
        theta: float = 1.0,
        strategy: str = "eq6",
    ):
        self.max_qsize = int(max_qsize)
        prio = make_priority(strategy, d_max, theta)  # validates the name
        self.strategy = prio.name
        self.d_max = prio.d_max
        self.theta = prio.theta

    def run(self, eng: "StreamEngine") -> None:
        state = eng.state
        buf = PriorityBuffer(
            self.max_qsize, eng.graph, make_priority(self.strategy, self.d_max, self.theta)
        )
        part_of = state.part_of
        d_max = self.d_max
        stats = BufferStats()

        def cascade(v: int, nbrs: np.ndarray) -> None:
            worklist = [(v, nbrs)]
            while worklist:
                u, un = worklist.pop()
                eng.place(u, un)
                for w in buf.notify_many(un):
                    worklist.append((w, buf.remove(w)))

        for _, batch, degs, expanded in _iter_chunk_expansions(eng):
            views = _chunk_views(expanded[1], degs)
            for i, v in enumerate(batch.tolist()):
                if part_of[v] != -1:
                    continue  # already placed via complete-eviction cascade
                nbrs = views[i]
                if nbrs.size >= d_max:
                    stats.bypass += 1
                    cascade(v, nbrs)
                    continue
                assigned = int((part_of[nbrs] != -1).sum())
                if assigned == nbrs.size and nbrs.size > 0:
                    cascade(v, nbrs)  # complete already
                    continue
                buf.push(v, assigned)
                stats.observe_len(len(buf))
                if buf.full:
                    u, un = buf.pop_best()
                    stats.evictions += 1
                    cascade(u, un)
        while len(buf):
            u, un = buf.pop_best()
            stats.drained += 1
            cascade(u, un)
        state.sync_mirror()
        eng.telemetry.update(stats.to_telemetry(self.strategy))


# ------------------------------------------------------------------ helpers
def _expand_csr_batch(indptr, indices, batch, degs):
    """Flat neighbour expansion of a chunk: ``(rows, cols)`` where flat
    position ``j`` is neighbour ``cols[j]`` of ``batch[rows[j]]``."""
    rows = np.repeat(np.arange(batch.shape[0], dtype=np.int64), degs)
    offs = np.zeros(batch.shape[0], dtype=np.int64)
    np.cumsum(degs[:-1], out=offs[1:])
    idx_in_row = np.arange(rows.shape[0], dtype=np.int64) - offs[rows]
    cols = indices[np.repeat(indptr[batch], degs) + idx_in_row]
    return rows, cols


def _chunk_views(cols, degs):
    """Per-row neighbour arrays from a flat chunk expansion."""
    if degs.shape[0] == 0:
        return []
    return np.split(cols, np.cumsum(degs[:-1]))


def _iter_chunk_expansions(eng: "StreamEngine"):
    """Yield ``(start, batch, degs, (rows, cols))`` per stream chunk."""
    indptr, indices = eng.graph.indptr, eng.graph.indices
    ids = eng.ids
    chunk = eng.config.chunk
    for start in range(0, ids.shape[0], chunk):
        batch = ids[start : start + chunk]
        degs = (indptr[batch + 1] - indptr[batch]).astype(np.int64)
        yield start, batch, degs, _expand_csr_batch(indptr, indices, batch, degs)


# ------------------------------------------------------------------- engine
class StreamEngine:
    """Drives one streaming pass: ``scorer.begin`` then ``policy.run``.

    ``ids`` overrides the stream order (otherwise computed from
    ``order``/``seed``); ``subpartitioner`` hooks CUTTANA's Def. 2
    sub-placement into every commit. The engine runs on the device of
    ``state.part_of_dev``."""

    def __init__(
        self,
        graph: CSRGraph,
        state: PartitionState,
        scorer,
        policy,
        *,
        subpartitioner: SubPartitioner | None = None,
        order: str = "natural",
        seed: int = 0,
        ids: np.ndarray | None = None,
        config: EngineConfig | None = None,
    ):
        self.graph = graph
        self.state = state
        self.scorer = scorer
        self.policy = policy
        self.subp = subpartitioner
        self.config = config or EngineConfig()
        self.ids = stream_order(graph, order, seed) if ids is None else ids
        # run counters surfaced in PartitionResult.telemetry: kernel_calls
        # counts chunk-histogram calls, single_place_calls the host-scored
        # placements (buffered policy); policies add their own
        self.telemetry: dict = {"kernel_calls": 0, "single_place_calls": 0}
        self.device = state.device
        self._dgraph = graph.to(self.device)
        self._ids_dev = torch.from_numpy(
            np.ascontiguousarray(self.ids, dtype=np.int64)
        ).to(self.device)
        self._zero_sizes = torch.zeros(state.k, dtype=torch.float32, device=self.device)
        self._pos = np.full(graph.num_vertices, -1, dtype=np.int64)

    def run(self) -> PartitionState:
        self.scorer.begin(self.state)
        self.policy.run(self)
        return self.state

    # ------------------------------------------------- per-vertex placement
    def place(self, v: int, nbrs: np.ndarray) -> int:
        """Score + place one vertex against the *fresh* host state (the
        buffered policy, whose placement order is data-dependent)."""
        state = self.state
        self.telemetry["single_place_calls"] += 1
        hist = state.neighbor_histogram(nbrs)
        scores = self.scorer.scores(state, hist)
        allowed = ~state.would_overflow(nbrs.size)
        p = state.argmax_tiebreak(scores, allowed)
        state.assign(v, p, nbrs.size)
        self.scorer.on_assign(state, p, nbrs.size)
        if self.subp is not None:
            self.subp.assign(v, p, nbrs, nbrs.size)
        return p

    # --------------------------------------------------- chunked histograms
    def chunk_histograms(self, start: int, batch: np.ndarray, expanded: tuple):
        """All C x K assigned-neighbour histograms of the chunk
        ``ids[start:start+C]`` from one kernel call on the device.

        Returns ``(hist, (dst, starts))``: ``hist`` is a list of C rows of K
        Python floats; for chunk position ``i``,
        ``dst[starts[i]:starts[i+1]]`` lists the later chunk positions that
        have ``batch[i]`` as a neighbour - the rows to bump when ``batch[i]``
        is assigned."""
        c = batch.shape[0]
        self.telemetry["kernel_calls"] += 1
        g = self._dgraph
        hist = fennel_scores_gather(
            g.indptr, g.indices, self.state.part_of_dev,
            self._ids_dev[start : start + c], self._zero_sizes, 0.0, 1.5,
        )
        rows, cols = expanded
        return hist.cpu().tolist(), self._inchunk_corr(batch, rows, cols)

    def flush_chunk(self, start: int, c: int, assigned: list[int]) -> None:
        """Write a chunk's placements into the device mirror of ``part_of``."""
        vals = torch.tensor(assigned, dtype=torch.int32).to(self.device)
        self.state.part_of_dev[self._ids_dev[start : start + c]] = vals

    def _inchunk_corr(self, batch: np.ndarray, rows: np.ndarray, cols: np.ndarray):
        """``(dst, starts)`` in-chunk correction lists for a chunk: for
        position ``i``, ``dst[starts[i]:starts[i+1]]`` are the later positions
        whose histograms must bump when ``batch[i]`` is assigned."""
        c = batch.shape[0]
        pos = self._pos
        pos[batch] = np.arange(c, dtype=np.int64)
        cpos = pos[cols]
        emask = (cpos >= 0) & (cpos < rows)
        pos[batch] = -1
        src = cpos[emask]
        dst = rows[emask]
        o = np.argsort(src, kind="stable")
        src, dst = src[o], dst[o]
        starts = np.searchsorted(src, np.arange(c + 1)).tolist()
        return (dst.tolist(), starts)
