"""Batched streaming engine: one scoring core for every engine-backed
partitioner (FENNEL, LDG, CUTTANA and its variants, HeiStream, the
incremental engine), sequential and sharded.

Port of ``repro.core.engine``: scorers, :class:`EngineConfig`,
:class:`ImmediatePolicy` (with the restreaming ``reassign`` mode),
:class:`BufferedPolicy`, the sharded policies
(:class:`ShardedImmediatePolicy`, :class:`ShardedBufferedPolicy`) around the
bulk-synchronous superstep core, and :class:`StreamEngine`.

The sequential stream is consumed in chunks of ``C`` vertices. For the
immediate policy, all ``C x K`` assigned-neighbour histograms of a chunk
come from ONE call of the partition-score kernel
(:mod:`repro_torch.kernels.partition_score`), which reads the chunk's CSR
rows and the ``part_of`` mirror directly on the device. A host loop then
places the chunk's vertices in stream order, correcting the histograms for
in-chunk neighbours, so assignments are bit-identical to the reference.
With ``EngineConfig(exact=False)`` (``cuttana-batched``) the histograms stay
one chunk stale, and rows above ``sample_cap`` neighbours are scored on a
seeded sample through one more launch, of the kernel's dense entry.

The sharded policies run S interleaved shard frontiers per superstep. ONE
call of the sharded partition-score kernel per superstep histograms every
shard's candidates against the superstep-start ``part_of``; the shard tasks
then place their candidates on pool threads, and the shared state is
exchanged at the superstep boundary. ``num_shards=1`` delegates to the
sequential policies.

What lives where, and why:

* On the device: the CSR ``indptr``/``indices`` of a resident graph, the
  stream order, the ``part_of`` mirror (:attr:`PartitionState.part_of_dev`)
  and the kernels' inputs and outputs. A memory-mapped graph
  (``backing == "mapped"``) is never copied whole: it takes the *rows
  route* on every device. Each chunk's fetch (on the prefetch thread when
  decode-ahead is on) decodes the chunk's rows and packs its local
  ``indptr`` and neighbour ids into one host buffer, pinned for a card;
  the main thread makes one host-to-device copy of it and launches the
  kernel's rows entry on it. A superstep packs its candidates, shard bounds,
  local ``indptr`` and neighbour ids into one buffer the same way. The immediate policy writes each chunk's placements
  into the mirror before the next launch; the sharded policies write each
  superstep's placements into it at the boundary exchange, before the next
  superstep's launch. An ``on_chunk_end`` hook (HeiStream's FM passes) may
  move the chunk's vertices on the host; the chunk's rows are written into
  the mirror after it. The buffered policy places one vertex at a time on
  the host and syncs the whole mirror once when it ends.
* On the host, in numpy as in the reference: the placement loops, the
  priority buffers and their eviction priorities (Eq. 6, ``gain``,
  ``completeness``), the sub-partitioner, the sampled rows' draws and the
  tie-break generator. Each placement depends on the one before it; a torch
  op per vertex would cost a launch plus a device-to-host sync per vertex,
  10-100x the numpy cost.
* Threads: the shard tasks, the buffered shards' ingests and the chained
  sub-partition merge run on :class:`~repro_torch.core.executor.ShardPool`
  threads and touch numpy only; the decode-ahead thread
  (:class:`~repro_torch.graph.prefetch.BatchPrefetcher`) decodes and packs
  host buffers only. Every launch, copy and mirror write stays on the main
  thread, on the current stream.

On the CPU (``device="cpu"``) the same code runs with CPU tensors, and the
kernel wrappers take their plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.base import FennelParams, PartitionState
from repro_torch.core.buffer import PriorityBuffer
from repro_torch.core.executor import ShardPool
from repro_torch.core.priority import BufferStats, make_priority
from repro_torch.core.profile import SuperstepProfiler
from repro_torch.core.subpartition import SubPartitioner
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.external import is_mapped
from repro_torch.graph.prefetch import BatchPrefetcher, PrefetchStats
from repro_torch.graph.stream import ShardedStream, stream_order
from repro_torch.kernels.partition_score.ops import (
    fennel_scores,
    fennel_scores_gather,
    fennel_scores_rows,
    fennel_scores_sharded_gather,
    fennel_scores_sharded_rows,
)

__all__ = [
    "FennelScorer",
    "LDGScorer",
    "ImmediatePolicy",
    "BufferedPolicy",
    "ShardedImmediatePolicy",
    "ShardedBufferedPolicy",
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

    def affine_arrays(self, v_counts, e_counts):
        """Vectorised :meth:`affine_update`: ``(mul, add)`` for a whole load
        view at once (``mul`` None => 1). Elementwise over any shape, and the
        same libm ``pow`` as the scalar path. Stateless - safe to call from
        concurrent shard tasks."""
        if self.hybrid:
            size = 0.5 * (v_counts + self.mu * e_counts)
        else:
            size = np.asarray(v_counts, dtype=np.float64)
        return None, -(self._ag * np.power(np.maximum(size, 0.0), self._gm1))


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

    def affine_arrays(self, v_counts, e_counts):
        """Vectorised :meth:`affine_update` (see FennelScorer): stateless,
        elementwise, including the nan path for edgeless edge-mode graphs."""
        loads = np.asarray(
            v_counts if self.balance_mode == "vertex" else e_counts,
            dtype=np.float64,
        )
        if self._cap == 0.0:
            return np.full_like(loads, np.nan), -(1e-9 * loads)
        return np.maximum(1.0 - loads / self._cap, 0.0), -(1e-9 * loads)


# ------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Chunking knobs for the scoring core.

    ``exact=True``: in-chunk histogram corrections, no sampling - results
    match the reference's sequential loops bit for bit. ``exact=False``
    (``cuttana-batched``): histograms stale by one chunk, and rows above
    ``sample_cap`` neighbours scored on a seeded uniform sample of
    ``sample_cap`` of them, the counts rescaled by ``degree / sample_cap``
    (``sample_cap`` is only read in this mode).

    ``max_workers`` threads run the sharded policies' per-shard superstep
    tasks (``None``/``0`` = auto: ``min(num_shards, cpu_count)``); results
    are bit-identical for every worker count because shard tasks write
    disjoint buffers. ``wave`` is the vectorised placement width inside a
    shard task: candidates are scored ``wave`` at a time against a frozen
    penalty/histogram view, refreshed exactly between waves.

    ``prefetch`` controls the decode-ahead pipeline for out-of-core graphs:
    ``"auto"`` overlaps chunk/superstep decode with scoring only when the
    graph is memory-mapped, ``"on"`` forces it, ``"off"`` disables it AND the
    sharded ahead-of-time frontier expansion - the synchronous baseline. The
    prefetcher consumes the identical fetch results in the identical order,
    so assignments are bit-identical across all three modes."""

    chunk: int = 512
    prefetch: str = "auto"
    max_workers: int | None = None
    wave: int = 128
    sample_cap: int = 512
    exact: bool = True

    def __post_init__(self) -> None:
        if self.prefetch not in ("auto", "on", "off"):
            raise ValueError(
                f'prefetch must be "auto", "on" or "off", got {self.prefetch!r}'
            )
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.sample_cap < 1:
            raise ValueError(f"sample_cap must be >= 1, got {self.sample_cap}")


def _resolve_prefetch(mode: str, graph) -> tuple[bool, bool]:
    """``(decode_ahead, ahead_prep)`` for a prefetch mode: ``"on"`` forces
    the decode pipeline, ``"off"`` disables it and the sharded ahead-of-time
    frontier expansion, ``"auto"`` enables the pipeline only for mapped
    graphs and leaves ahead-prep on - resident runs keep their overlap.
    ``EngineConfig`` has validated ``mode``."""
    if mode == "on":
        return True, True
    if mode == "off":
        return False, False
    return is_mapped(graph), True


# ----------------------------------------------------------------- policies
class ImmediatePolicy:
    """Place every stream vertex as soon as it arrives (FENNEL / LDG /
    CUTTANA without its buffer), scoring each chunk with one kernel call.
    With ``reassign=True`` the stream *re-visits* already assigned vertices
    (restreaming): each vertex is pulled out of its current partition,
    rescored against the full assignment, and may move."""

    def __init__(self, reassign: bool = False):
        self.reassign = reassign

    def run(self, eng: "StreamEngine") -> None:
        """Host loop for scorers with the affine contract
        ``scores == hist * mul + add``. The K-wide selection runs in plain
        Python over lists (for K <= a few hundred, numpy dispatch overhead
        dwarfs the arithmetic); the numpy state and the device mirror are
        written once per chunk. Every operation is the same IEEE double
        computation as the reference, so results are bit-identical."""
        if self.reassign and eng.subp is not None:
            # SubPartitioner has no unassign: re-adding an already-placed
            # vertex would double-count its sub-partition mass
            raise ValueError("reassign mode does not support a subpartitioner")
        state = eng.state
        scorer = eng.scorer
        subp = eng.subp
        part_of = state.part_of
        reassign = self.reassign
        v_counts, e_counts = state.v_counts, state.e_counts
        k = state.k
        krange = range(k)
        rng = state.rng
        vertex_mode = state.balance_mode == "vertex"
        cap = state.vertex_capacity if vertex_mode else state.edge_capacity
        neg_inf = float("-inf")
        sc = [neg_inf] * k  # per-vertex score buffer (neg_inf == disallowed)
        hook = eng.on_chunk_end
        for start, batch, degs, expanded in _iter_chunk_expansions(eng, pack=eng.rows_route):
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
            dst, starts = corr if corr is not None else (None, None)
            for i in range(len(bl)):
                v, deg = bl[i], dl[i]
                cur = -1
                if reassign:
                    cur = int(part_of[v])  # pre-pass value: writes deferred
                    v_list[cur] -= 1
                    e_list[cur] -= deg
                    u = scorer.affine_update(v_list[cur], e_list[cur])
                    if mul is not None:
                        mul[cur] = u[0]
                    add[cur] = u[1]
                row = H[i]
                inc = 1 if vertex_mode else deg
                best = neg_inf
                if mul is None:
                    for p in krange:
                        if load[p] + inc > cap and p != cur:
                            sc[p] = neg_inf
                            continue
                        s = row[p] + add[p]
                        sc[p] = s
                        if s > best:
                            best = s
                else:
                    for p in krange:
                        if load[p] + inc > cap and p != cur:
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
                if corr is not None and p != cur:
                    if reassign:
                        for j in dst[starts[i] : starts[i + 1]]:
                            rj = H[j]
                            rj[cur] -= 1.0
                            rj[p] += 1.0
                    else:
                        for j in dst[starts[i] : starts[i + 1]]:
                            H[j][p] += 1.0
            # flush the chunk into the numpy state and the device mirror
            part_of[batch] = assigned
            v_counts[:] = v_list
            e_counts[:] = e_list
            if hook is not None:
                # the hook (HeiStream's FM passes) may move the chunk's own
                # vertices on the host; the mirror takes the rows it leaves
                hook(eng, batch)
                assigned = part_of[batch]
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
        prio = make_priority(self.strategy, self.d_max, self.theta)
        buf = PriorityBuffer(self.max_qsize, graph=eng.graph, priority=prio)
        part_of = state.part_of
        d_max = self.d_max
        track = prio.tracks_parts
        stats = BufferStats()

        def cascade(v: int, nbrs: np.ndarray) -> None:
            worklist = [(v, nbrs)]
            while worklist:
                u, un = worklist.pop()
                p = eng.place(u, un)
                for w in buf.notify_many(un, p if track else None):
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
                nbr_parts = part_of[nbrs]
                assigned = int((nbr_parts != -1).sum())
                if assigned == nbrs.size and nbrs.size > 0:
                    cascade(v, nbrs)  # complete already
                    continue
                buf.push(v, nbrs, assigned, nbr_parts if track else None)
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


def _pack_rows(head: list, degs: np.ndarray, cols: np.ndarray, pin: bool) -> torch.Tensor:
    """One int64 host buffer (pinned when ``pin``) holding the int64 arrays
    of ``head`` back to back, then the rows' local ``indptr`` (len(degs) + 1
    offsets), then ``cols`` as int32 - what one host-to-device copy takes to
    the card. A fresh buffer a call: the caching host allocator keeps it
    from reuse until the copy that reads it has ended."""
    h = sum(a.shape[0] for a in head)
    c, nnz = degs.shape[0], cols.shape[0]
    buf = torch.empty(h + c + 1 + (nnz + 1) // 2, dtype=torch.int64, pin_memory=pin)
    a = buf.numpy()
    o = 0
    for x in head:
        a[o : o + x.shape[0]] = x
        o += x.shape[0]
    a[o] = 0
    np.cumsum(degs, out=a[o + 1 : o + 1 + c])
    a[o + c + 1 :].view(np.int32)[:nnz] = cols
    return buf


def _unpack_rows(dev: torch.Tensor, h: int, c: int, nnz: int):
    """``(local_indptr, cols)`` views of a :func:`_pack_rows` buffer whose
    head holds ``h`` int64 values."""
    return dev[h : h + c + 1], dev[h + c + 1 :].view(torch.int32)[:nnz]


def _iter_chunk_expansions(eng: "StreamEngine", pack: bool = False):
    """Yield ``(start, batch, degs, (rows, cols[, packed]))`` per stream
    chunk; with ``pack`` the chunk's rows also come packed for the rows
    route (:func:`_pack_rows`).

    The fetch touches only the immutable CSR read surface, so when the
    engine's prefetcher is enabled chunk t+1 is expanded (for a compressed
    mapped graph: varint-decoded) and packed on the prefetch thread while
    chunk t is being scored. Inline and prefetched paths run the identical
    fetch in the identical order, so the consumed stream is bit-identical
    either way."""
    indptr, indices = eng.graph.indptr, eng.graph.indices
    ids = eng.ids
    chunk = eng.config.chunk
    pin = eng.device.type == "cuda"

    def fetch(start):
        batch = ids[start : start + chunk]
        degs = (indptr[batch + 1] - indptr[batch]).astype(np.int64)
        rows, cols = _expand_csr_batch(indptr, indices, batch, degs)
        if pack:
            return start, batch, degs, (rows, cols, _pack_rows([], degs, cols, pin))
        return start, batch, degs, (rows, cols)

    starts = range(0, ids.shape[0], chunk)
    if not eng.prefetch_enabled:
        for s in starts:
            yield fetch(s)
        return
    pf = BatchPrefetcher(fetch, starts, stats=eng.prefetch_stats)
    try:
        yield from pf
    finally:
        pf.close()


# --------------------------------------------------------- sharded policies
def _check_num_shards(num_shards) -> int:
    s = int(num_shards)
    if s < 1 or s != num_shards:
        raise ValueError(f"num_shards must be a positive integer, got {num_shards!r}")
    return s


@dataclasses.dataclass
class _ShardPrep:
    """Frontier expansion for one shard's superstep batch.

    Everything here is derived from the immutable CSR plus the batch ids
    alone - no dependence on the evolving assignment - so preps can be (and
    are) computed on pool threads one superstep AHEAD of their use.
    """

    batch: np.ndarray  # int64[c] candidate ids (contiguous)
    degs: np.ndarray  # int64[c]
    rows: np.ndarray  # int64[nnz] local row index per neighbour slot
    cols: np.ndarray  # int64[nnz] neighbour ids
    corr_src: np.ndarray  # int64[nc] in-shard same-superstep pairs sorted by
    corr_dst: np.ndarray  # src; dst is placed later than src in shard order


def _prepare_shard(indptr, indices, batch) -> _ShardPrep:
    """Build one shard's :class:`_ShardPrep` (numpy only, thread-safe)."""
    batch = np.ascontiguousarray(batch, dtype=np.int64)
    degs = (indptr[batch + 1] - indptr[batch]).astype(np.int64)
    rows, cols = _expand_csr_batch(indptr, indices, batch, degs)
    if cols.size:
        # in-shard same-superstep correction pairs via sorted membership
        # lookup: position of each neighbour id inside the batch, if any
        order = np.argsort(batch, kind="stable")
        sb = batch[order]
        loc = np.searchsorted(sb, cols)
        np.minimum(loc, sb.size - 1, out=loc)
        cpos = np.where(sb[loc] == cols, order[loc], -1)
        emask = (cpos >= 0) & (cpos < rows)
        src, dst = cpos[emask], rows[emask]
        o = np.argsort(src, kind="stable")
        src, dst = src[o], dst[o]
    else:
        src = dst = np.empty(0, dtype=np.int64)
    return _ShardPrep(batch, degs, rows, cols, src, dst)


class _SuperstepRunner:
    """Bulk-synchronous superstep core shared by the sharded policies.

    Per superstep, every shard's candidate vertices are histogrammed against
    the *superstep-start snapshot* of ``part_of`` in ONE sharded
    partition-score call on the main thread (:meth:`_histograms`). Each
    shard then places its candidates against a local view (snapshot + its
    own deltas, with the remaining per-partition capacity split evenly
    across shards). Assignments and loads are exchanged only at the
    superstep boundary - the paper's relaxed-consistency parallel design.
    Same-shard same-superstep neighbours are corrected exactly between
    placement waves; cross-shard ones are not, and are counted as
    ``boundary_conflicts`` for the merge + coarsen + refine pass to
    reconcile.

    Concurrency model: each shard is one task on a :class:`ShardPool`. A
    task reads only snapshot arrays and its own :class:`_ShardPrep`, and
    writes only its disjoint slices of the superstep's assignment/histogram
    buffers - tasks commute, so assignments are bit-identical for every
    ``max_workers``. The merge back into shared state is a vectorised
    bincount reduction on the main thread, which also writes the
    placements into the device mirror; the sub-partition merge is a
    FIFO-chained pool task that may overlap the next superstep's scoring.
    """

    def __init__(
        self,
        eng: "StreamEngine",
        sharded: ShardedStream,
        reassign: bool = False,
        need_cols: bool = False,
    ):
        if not hasattr(eng.scorer, "affine_arrays"):
            raise ValueError(
                "sharded policies require a scorer with the affine contract "
                "(scores == hist * mul + add); got "
                f"{type(eng.scorer).__name__}"
            )
        if reassign and eng.subp is not None:
            # same contract as ImmediatePolicy: SubPartitioner has no unassign
            raise ValueError("reassign mode does not support a subpartitioner")
        self.eng = eng
        self.sharded = sharded
        self.reassign = reassign
        self.need_cols = need_cols
        state = eng.state
        self.k = state.k
        self.shard_of = sharded.shard_of(eng.graph.num_vertices)
        self.step_mark = np.full(eng.graph.num_vertices, -1, dtype=np.int64)
        self.step = 0
        self.sync_rounds = 0
        self.boundary_conflicts = 0
        self.vertex_mode = state.balance_mode == "vertex"
        self.cap = (
            state.vertex_capacity if self.vertex_mode else state.edge_capacity
        )
        self.wave = max(int(eng.config.wave), 1)
        self.pool = ShardPool(eng.config.max_workers, sharded.num_shards)
        self.profile = SuperstepProfiler(workers=self.pool.workers)
        self.prefetch_ahead = eng.prefetch_ahead
        # with an inline (single-worker) pool, prepare_async would run on the
        # calling thread and the ahead-prep overlap would silently vanish; a
        # dedicated decode thread keeps the pipeline real on one core
        self._prefetch_ex: ThreadPoolExecutor | None = (
            ThreadPoolExecutor(1, thread_name_prefix="prefetch")
            if eng.prefetch_enabled and self.pool.workers == 1
            else None
        )
        self._zero_sizes = torch.zeros(
            (sharded.num_shards, state.k), dtype=torch.float32, device=eng.device
        )
        self._subp_chain = None
        self._v0: np.ndarray | None = None
        self._e0: np.ndarray | None = None

    def close(self) -> None:
        """Flush the chained sub-partition merges and stop the pool. Must
        run before anything reads ``eng.subp`` state (phase 2)."""
        if self._subp_chain is not None:
            t0 = time.perf_counter()
            self._subp_chain.result()
            self.profile.add("merge", time.perf_counter() - t0)
            self._subp_chain = None
        if self._prefetch_ex is not None:
            self._prefetch_ex.shutdown(wait=True)
            self._prefetch_ex = None
        self.pool.shutdown()

    # ----------------------------------------------------------- prefetch
    def submit_decode(self, fn, *args):
        """Submit decode work: the dedicated prefetch thread when the pool
        is inline, else the pool."""
        ex = self._prefetch_ex
        return (ex.submit if ex is not None else self.pool.submit)(fn, *args)

    def prepare_async(self, batches: list[np.ndarray]) -> list:
        """Submit per-shard frontier expansion; futures align with shards."""
        eng = self.eng
        indptr, indices = eng.graph.indptr, eng.graph.indices
        fn = _prepare_shard
        if eng.prefetch_enabled:
            stats = eng.prefetch_stats

            def fn(ip, ix, b):
                t0 = time.perf_counter()
                try:
                    return _prepare_shard(ip, ix, b)
                finally:
                    stats.record_decode(time.perf_counter() - t0)

        return [
            self.submit_decode(fn, indptr, indices, b) if b.shape[0] else None
            for b in batches
        ]

    def wait_preps(self, futs: list, record: bool = False) -> list[_ShardPrep | None]:
        hit = all(f is None or f.done() for f in futs)
        t0 = time.perf_counter()
        preps = [f.result() if f is not None else None for f in futs]
        wait = time.perf_counter() - t0
        self.profile.add("prep", wait)
        if record and self.eng.prefetch_enabled:
            self.eng.prefetch_stats.record_wait(wait, hit)
        return preps

    # -------------------------------------------------------- histogramming
    def _histograms(self, big: np.ndarray, counts: list[int], live: list[_ShardPrep]):
        """float64[total, K] assigned-neighbour histograms of the whole
        superstep from ONE sharded partition-score call, and the candidates'
        ids on the device. Rows are the candidates shard after shard; the
        engine scores with ``alpha=0`` (the penalties change with every
        placement, so the shard tasks apply them on the host), so the counts
        are exact integers and equal the reference's. On the rows route the
        candidates, shard bounds and the shards' decoded rows (``live``)
        reach the device in one copy."""
        eng = self.eng
        total = big.shape[0]
        if eng.rows_route:
            degs = np.concatenate([p.degs for p in live])
            cols = np.concatenate([p.cols for p in live])
            bounds = np.zeros(len(counts) + 1, dtype=np.int64)
            np.cumsum(counts, out=bounds[1:])
            head = total + bounds.shape[0]
            dev = _pack_rows(
                [big, bounds], degs, cols, eng.device.type == "cuda"
            ).to(eng.device, non_blocking=True)
            local_indptr, cols_dev = _unpack_rows(dev, head, total, cols.shape[0])
            out = fennel_scores_sharded_rows(
                local_indptr, cols_dev, eng.state.part_of_dev,
                dev[total:head], self._zero_sizes, 0.0, 1.5,
            )
            return out.cpu().numpy().astype(np.float64), dev[:total]
        packed = np.empty(total + len(counts) + 1, dtype=np.int64)
        packed[:total] = big
        packed[total] = 0
        np.cumsum(counts, out=packed[total + 1 :])
        # one host-to-device copy for the candidates and the shard bounds
        packed_dev = torch.from_numpy(packed).to(eng.device)
        batch_dev = packed_dev[:total]
        g = eng._dgraph
        out = fennel_scores_sharded_gather(
            g.indptr, g.indices, eng.state.part_of_dev, batch_dev,
            packed_dev[total:], self._zero_sizes, 0.0, 1.5,
        )
        return out.cpu().numpy().astype(np.float64), batch_dev

    # ------------------------------------------------------- per-shard task
    def _shard_task(self, prep: _ShardPrep, hist_rows, out, room):
        """One shard's superstep work: wave-vectorised placement. Reads only
        snapshot arrays and ``prep``; writes only this shard's
        ``hist_rows``/``out`` slices - safe and deterministic under any pool
        scheduling."""
        t0 = time.perf_counter()
        old = (
            self.eng.state.part_of[prep.batch].astype(np.int64)
            if self.reassign
            else None
        )
        t1 = time.perf_counter()
        self._place_shard(prep, hist_rows, out, room, old)
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, old

    def _place_shard(self, prep, hist, out, room, old):
        """Wave-vectorised placement of one shard's candidates.

        ``wave`` candidates are scored at a time against the superstep
        snapshot plus this shard's own running deltas: within a wave the
        balance penalty and in-shard neighbour histograms are frozen; between
        waves both are refreshed exactly. A wave whose picks would overshoot
        a partition's shard-local headroom is replayed per vertex against
        live loads, so the capacity rule is enforced exactly as
        sequentially. Ties break to the lowest partition index -
        deterministic without consuming shared rng state, which is what
        makes assignments independent of the worker count.
        """
        k = self.k
        scorer = self.eng.scorer
        c = prep.batch.shape[0]
        degf = prep.degs.astype(np.float64)
        inc = np.ones(c, dtype=np.float64) if self.vertex_mode else degf
        v_loc = self._v0.copy()
        e_loc = self._e0.copy()
        used = np.zeros(k, dtype=np.float64)
        wave = self.wave
        csrc, cdst = prep.corr_src, prep.corr_dst
        for g0 in range(0, c, wave):
            g1 = min(g0 + wave, c)
            g = g1 - g0
            rows_i = np.arange(g)
            hb = hist[g0:g1]
            mul, add = scorer.affine_arrays(v_loc, e_loc)
            sc = hb + add if mul is None else hb * mul + add
            incw = inc[g0:g1]
            fits = used + incw[:, None] <= room
            cur = None
            if old is not None:
                # pull each candidate out of its current partition in its
                # own row's view: staying put is always allowed, and cur's
                # penalty reflects the vertex's removal (sequential rule)
                cur = old[g0:g1]
                fits[rows_i, cur] = True
                smul, sadd = scorer.affine_arrays(
                    v_loc[cur] - 1.0, e_loc[cur] - degf[g0:g1]
                )
                own = hb[rows_i, cur]
                sc[rows_i, cur] = own + sadd if smul is None else own * smul + sadd
            masked = np.where(fits, sc, -np.inf)
            choice = masked.argmax(axis=1).astype(np.int64)
            best = masked[rows_i, choice]
            fallback = ~(best > -np.inf)  # -inf (or nan): headroom exhausted
            if fallback.any():
                loads_loc = v_loc if self.vertex_mode else e_loc
                choice[fallback] = int(loads_loc.argmin())
            add_w = np.bincount(choice, weights=incw, minlength=k)
            proj = used + add_w
            if cur is not None:
                proj = proj - np.bincount(cur, weights=incw, minlength=k)
            repaired = False
            if (proj > room).any():
                nf = np.flatnonzero(~fallback)
                # fallback-only overshoot mirrors the sequential fallback
                # (capacity is advisory there); real picks must not overshoot
                if nf.size and (proj > room)[choice[nf]].any():
                    repaired = True
                    self._repair_wave(
                        g0, g1, sc, incw, degf, room, used, v_loc, e_loc,
                        choice, cur,
                    )
            if not repaired:
                used += add_w
                v_loc += np.bincount(choice, minlength=k).astype(np.float64)
                e_loc += np.bincount(choice, weights=degf[g0:g1], minlength=k)
                if cur is not None:
                    used -= np.bincount(cur, weights=incw, minlength=k)
                    v_loc -= np.bincount(cur, minlength=k).astype(np.float64)
                    e_loc -= np.bincount(cur, weights=degf[g0:g1], minlength=k)
            out[g0:g1] = choice
            if csrc.size:
                lo = np.searchsorted(csrc, g0)
                hi = np.searchsorted(csrc, g1)
                if hi > lo:
                    d_ = cdst[lo:hi]
                    later = d_ >= g1
                    if later.any():
                        d_ = d_[later]
                        s_ = csrc[lo:hi][later] - g0
                        np.add.at(hist, (d_, choice[s_]), 1.0)
                        if cur is not None:
                            np.add.at(hist, (d_, cur[s_]), -1.0)

    def _repair_wave(
        self, g0, g1, sc, incw, degf, room, used, v_loc, e_loc, choice, cur
    ):
        """Scalar replay of one wave against live shard-local loads (frozen
        wave scores): only runs when the vectorised projection would
        overshoot, so the balance invariant is exactly the sequential one."""
        vertex_mode = self.vertex_mode
        for i in range(g1 - g0):
            inc_i = incw[i]
            f_i = used + inc_i <= room
            if cur is not None:
                f_i[cur[i]] = True
            m = np.where(f_i, sc[i], -np.inf)
            b = m.max()
            if b > -np.inf:
                p = int(m.argmax())
            else:
                p = int((v_loc if vertex_mode else e_loc).argmin())
            choice[i] = p
            d = degf[g0 + i]
            used[p] += inc_i
            v_loc[p] += 1.0
            e_loc[p] += d
            if cur is not None:
                q = cur[i]
                used[q] -= inc_i
                v_loc[q] -= 1.0
                e_loc[q] -= d

    # ----------------------------------------------------------- superstep
    def run_superstep(
        self,
        batches: list[np.ndarray],
        preps: list[_ShardPrep | None] | None = None,
    ) -> np.ndarray | None:
        """Score + place all shards' candidates concurrently, commit at the
        boundary via a vectorised reduction.

        Returns, when ``need_cols``, a ``(cols, parts)`` pair: the flat
        neighbour-id array of everything placed (the buffered policy
        notifies every shard buffer with it) and ``parts[j]``, the partition
        the owner of neighbour slot ``j`` was just placed in (read by
        partition-tracking buffer strategies); else the placed vertex ids;
        None when the superstep had no candidates (and then it launches
        nothing).
        """
        eng = self.eng
        state = eng.state
        self.step += 1
        counts = [int(b.shape[0]) for b in batches]
        total = sum(counts)
        if total == 0:
            return None
        if preps is None:
            preps = self.wait_preps(self.prepare_async(batches))
        eng.telemetry["kernel_calls"] += 1
        k = self.k
        v_counts, e_counts = state.v_counts, state.e_counts
        loads0 = v_counts if self.vertex_mode else e_counts
        # remaining per-partition capacity split evenly across the shards
        # that actually place this superstep (empty batches - e.g. drained
        # cursors - must not starve the active ones)
        active = sum(1 for c in counts if c)
        room = np.maximum(self.cap - loads0, 0.0) / active
        self._v0 = v_counts.copy()
        self._e0 = e_counts.copy()
        bounds = np.cumsum(np.asarray(counts, dtype=np.int64))
        starts = bounds - np.asarray(counts, dtype=np.int64)
        live = [p for p in preps if p is not None]
        big = np.concatenate([p.batch for p in live])
        assigned_flat = np.empty(total, dtype=np.int64)
        # one kernel call for every shard, on the main thread, before the
        # shard tasks fan out
        t_k = time.perf_counter()
        hist_all, big_dev = self._histograms(big, counts, live)
        score_s = time.perf_counter() - t_k
        # fan out: one task per non-empty shard, each writing its disjoint
        # slice of assigned_flat (and mutating only its own hist rows)
        t_par = time.perf_counter()
        futs = []
        for s, prep in enumerate(preps):
            if prep is None:
                continue
            futs.append(
                self.pool.submit(
                    self._shard_task, prep, hist_all[starts[s] : bounds[s]],
                    assigned_flat[starts[s] : bounds[s]], room,
                )
            )
        place_s = 0.0
        olds = []
        for f in futs:
            h_s, p_s, old = f.result()
            score_s += h_s
            place_s += p_s
            if old is not None:
                olds.append(old)
        parallel_wall = time.perf_counter() - t_par
        # ------------------------------------------------ boundary exchange
        t_x = time.perf_counter()
        degf = np.concatenate([p.degs for p in live]).astype(np.float64)
        if self.reassign:
            old_flat = np.concatenate(olds)
            v_counts -= np.bincount(old_flat, minlength=k).astype(np.float64)
            e_counts -= np.bincount(old_flat, weights=degf, minlength=k)
        state.part_of[big] = assigned_flat
        # the device mirror, before the next superstep's launch: one copy and
        # one index write
        state.part_of_dev[big_dev] = torch.from_numpy(
            assigned_flat.astype(np.int32)
        ).to(eng.device)
        v_counts += np.bincount(assigned_flat, minlength=k).astype(np.float64)
        e_counts += np.bincount(assigned_flat, weights=degf, minlength=k)
        self.sync_rounds += 1
        self.step_mark[big] = self.step
        conflicts = 0
        for s, prep in enumerate(preps):
            if prep is None or prep.cols.size == 0:
                continue
            same_step = self.step_mark[prep.cols] == self.step
            conflicts += int((same_step & (self.shard_of[prep.cols] != s)).sum())
        # each conflicting edge appears once from either endpoint
        self.boundary_conflicts += conflicts // 2
        exchange_s = time.perf_counter() - t_x
        # ----------------------------------- overlapped sub-partition merge
        merge_s = 0.0
        if eng.subp is not None:
            t_m = time.perf_counter()
            rows_g = np.concatenate(
                [p.rows + starts[s] for s, p in enumerate(preps) if p is not None]
            )
            cols_g = np.concatenate([p.cols for p in live])
            degs_g = np.concatenate([p.degs for p in live])
            # FIFO-chained: superstep t's sub-placement may overlap t+1's
            # scoring (placement never reads sub-partition state), but
            # merges apply in superstep order and close() flushes the chain
            # before phase 2 reads it
            self._subp_chain = self.pool.submit_after(
                self._subp_chain, eng.subp.assign_superstep,
                big, assigned_flat, degs_g, rows_g, cols_g, self.wave,
            )
            merge_s = time.perf_counter() - t_m
        self.profile.record(
            score=score_s, place=place_s, exchange=exchange_s, merge=merge_s,
            parallel_wall=parallel_wall,
        )
        if self.need_cols:
            cols_all = np.concatenate([p.cols for p in live])
            # partition of the *placer*, aligned with its neighbour slots
            parts_all = np.concatenate(
                [
                    assigned_flat[starts[s] : bounds[s]][p.rows]
                    for s, p in enumerate(preps)
                    if p is not None
                ]
            )
            return cols_all, parts_all
        return big

    def finalize_telemetry(self) -> None:
        self.profile.add_queue_wait(self.pool.queue_wait_s)
        self.eng.telemetry.update(
            supersteps=self.step,
            sync_rounds=self.sync_rounds,
            boundary_conflicts=self.boundary_conflicts,
            num_shards=self.sharded.num_shards,
            max_workers=self.pool.workers,
            profile=self.profile.to_dict(),
        )


class ShardedImmediatePolicy:
    """S interleaved shard frontiers placed per bulk-synchronous superstep.

    The FENNEL/LDG analogue of the paper's parallel CUTTANA: every superstep
    each shard advances its cursor by ``config.chunk`` vertices, all shards'
    chunks are scored in one sharded kernel call, and the shared state is
    synchronized at the boundary. ``num_shards=1`` is *defined* as the
    sequential engine (delegates to :class:`ImmediatePolicy`).

    ``reassign=True`` is the restreaming mode (every vertex already holds an
    assignment; each superstep pulls its candidates out of their current
    partitions in the shard-local view and may move them).
    """

    def __init__(self, num_shards: int, reassign: bool = False):
        self.num_shards = _check_num_shards(num_shards)
        self.reassign = reassign

    def run(self, eng: "StreamEngine") -> None:
        if self.num_shards == 1:
            ImmediatePolicy(reassign=self.reassign).run(eng)
            eng.telemetry.update(
                supersteps=0, sync_rounds=0, boundary_conflicts=0, num_shards=1
            )
            return
        sharded = ShardedStream.from_ids(eng.ids, self.num_shards)
        runner = _SuperstepRunner(eng, sharded, reassign=self.reassign)
        try:
            steps = list(sharded.superstep_batches(eng.config.chunk))
            if not runner.prefetch_ahead:
                # prefetch="off": the synchronous baseline - every superstep
                # expands its own frontier before scoring
                for batches in steps:
                    runner.run_superstep(batches)
            else:
                prefetched = runner.prepare_async(steps[0]) if steps else None
                for t, batches in enumerate(steps):
                    preps = runner.wait_preps(prefetched, record=True)
                    # overlap: expand superstep t+1's frontier while t scores,
                    # places and merges (expansion reads only the immutable CSR)
                    prefetched = (
                        runner.prepare_async(steps[t + 1])
                        if t + 1 < len(steps)
                        else None
                    )
                    runner.run_superstep(batches, preps)
        finally:
            runner.close()
        runner.finalize_telemetry()


class ShardedBufferedPolicy:
    """Parallel CUTTANA Algorithm 1: shard-local priority buffers around the
    bulk-synchronous superstep core.

    Each shard ingests ``config.chunk`` stream vertices per superstep into
    its own :class:`PriorityBuffer` (D_max bypasses and already-complete
    vertices become immediate candidates; overflow evicts the best-scored
    ones), all shards' candidates are placed through ONE sharded kernel
    call, and at the boundary every shard's buffer is notified with the
    whole superstep's placements - cross-shard visibility arrives exactly
    one superstep late (relaxed consistency). Complete vertices surfacing at
    a boundary are placed in the next superstep; buffers drain
    chunk-at-a-time once their cursor is exhausted. ``num_shards=1``
    delegates to the sequential :class:`BufferedPolicy`.
    """

    def __init__(
        self,
        num_shards: int,
        max_qsize: int,
        d_max: int,
        theta: float = 1.0,
        strategy: str = "eq6",
    ):
        self.num_shards = _check_num_shards(num_shards)
        self.max_qsize = int(max_qsize)
        prio = make_priority(strategy, d_max, theta)  # validates the name
        self.strategy = prio.name
        self.tracks_parts = prio.tracks_parts
        self.d_max = prio.d_max
        self.theta = prio.theta

    def run(self, eng: "StreamEngine") -> None:
        if self.num_shards == 1:
            BufferedPolicy(self.max_qsize, self.d_max, self.theta, self.strategy).run(eng)
            eng.telemetry.update(
                supersteps=0, sync_rounds=0, boundary_conflicts=0, num_shards=1
            )
            return
        num_shards = self.num_shards
        graph = eng.graph
        indptr, indices = graph.indptr, graph.indices
        part_of = eng.state.part_of
        sharded = ShardedStream.from_ids(eng.ids, num_shards)
        track = self.tracks_parts
        runner = _SuperstepRunner(eng, sharded, need_cols=True)
        chunk = max(int(eng.config.chunk), 1)
        bufs = [
            PriorityBuffer(
                self.max_qsize,
                graph=graph,
                priority=make_priority(self.strategy, self.d_max, self.theta),
            )
            for _ in range(num_shards)
        ]
        pending: list[list[int]] = [[] for _ in range(num_shards)]
        cursors = [0] * num_shards
        d_max = self.d_max
        prefetch_on = eng.prefetch_enabled
        stats = eng.prefetch_stats
        # decode-ahead slots: shard -> (cursor snapshot, in-flight scan).
        # Each slot is written on the main thread between rounds and consumed
        # only by that shard's ingest task, so access stays disjoint.
        adm: dict[int, tuple[int, object]] = {}

        def scan(s: int, cursor: int):
            """Assignment-independent half of shard s's ingest: the stream
            slice and its (decoded) neighbour expansion. Reads only the
            immutable CSR, so it may overlap a superstep writing ``part_of``."""
            take = sharded.shards[s][cursor : cursor + chunk]
            if not take.shape[0]:
                return take, None, None
            tdegs = (indptr[take + 1] - indptr[take]).astype(np.int64)
            return take, tdegs, _expand_csr_batch(indptr, indices, take, tdegs)

        def timed_scan(s: int, cursor: int):
            t0 = time.perf_counter()
            try:
                return scan(s, cursor)
            finally:
                stats.record_decode(time.perf_counter() - t0)

        def prefetch_scans():
            """Queue the next round's admission scans: once every ingest has
            returned, the round's cursors are final, so the next slices are
            known and can decode while the superstep scores and places."""
            for s in range(num_shards):
                if cursors[s] < sharded.shards[s].shape[0]:
                    adm[s] = (cursors[s], runner.submit_decode(timed_scan, s, cursors[s]))

        def ingest(s: int):
            """One shard's superstep ingest: admission scan + buffer churn.
            Touches only shard s's buffer/pending/cursor slots and reads the
            boundary-stable ``part_of``, so all S ingests run concurrently;
            per-shard counters come back for a deterministic main-thread sum.
            """
            cand = pending[s]
            pending[s] = []
            buf = bufs[s]
            pre = adm.pop(s, None)
            if pre is not None and pre[0] == cursors[s]:
                fut = pre[1]
                was_ready = fut.done()
                t0 = time.perf_counter()
                take, tdegs, texp = fut.result()
                stats.record_wait(time.perf_counter() - t0, was_ready)
            else:
                take, tdegs, texp = scan(s, cursors[s])
            cursors[s] += take.shape[0]
            evicted = drained_n = bypass_n = 0
            if take.shape[0]:
                trows, tcols = texp
                tparts = part_of[tcols]
                asg = np.bincount(trows[tparts != -1], minlength=take.shape[0])
                byp = tdegs >= d_max
                comp = (~byp) & (asg == tdegs) & (tdegs > 0)
                tl = take.tolist()
                al = asg.tolist()
                bypl = byp.tolist()
                compl = comp.tolist()
                if track:
                    toffs = np.zeros(take.shape[0] + 1, dtype=np.int64)
                    np.cumsum(tdegs, out=toffs[1:])
                for i in range(len(tl)):
                    if bypl[i]:
                        bypass_n += 1
                        cand.append(tl[i])
                    elif compl[i]:
                        cand.append(tl[i])
                    else:
                        buf.push(
                            tl[i],
                            None,
                            al[i],
                            tparts[toffs[i] : toffs[i + 1]] if track else None,
                        )
                while buf.full:
                    u, _ = buf.pop_best()
                    evicted += 1
                    cand.append(u)
            elif len(buf):
                # cursor exhausted: drain the buffer in score order,
                # chunk candidates per superstep
                for _ in range(max(chunk - len(cand), 0)):
                    if not len(buf):
                        break
                    u, _ = buf.pop_best()
                    drained_n += 1
                    cand.append(u)
            return (
                np.asarray(cand, dtype=np.int64),
                evicted, drained_n, bypass_n, len(buf),
            )

        def notify(s: int, placed_cols: np.ndarray, placed_parts=None):
            """Boundary: shard s's buffer learns about ALL placements.
            Mutates only shard s's buffer and pending slot."""
            buf = bufs[s]
            if not len(buf):
                return
            for w in buf.notify_many(placed_cols, placed_parts):
                buf.remove(w)
                pending[s].append(w)

        bstats = BufferStats()
        try:
            if prefetch_on:
                prefetch_scans()
            while True:
                t0 = time.perf_counter()
                results = [
                    f.result()
                    for f in [
                        runner.pool.submit(ingest, s) for s in range(num_shards)
                    ]
                ]
                runner.profile.add("prep", time.perf_counter() - t0)
                if prefetch_on:
                    prefetch_scans()
                batches = [r[0] for r in results]
                for _, ev, dr, by, blen in results:
                    bstats.evictions += ev
                    bstats.drained += dr
                    bstats.bypass += by
                    bstats.observe_len(blen)
                if all(b.shape[0] == 0 for b in batches):
                    exhausted = all(
                        cursors[s] >= sharded.shards[s].shape[0]
                        for s in range(num_shards)
                    )
                    if exhausted and not any(len(b) for b in bufs):
                        break
                    # everything ingested got buffered - still a superstep,
                    # no sync and no launch
                    runner.step += 1
                    continue
                res = runner.run_superstep(batches)
                if res is None:
                    continue
                cols, placed_parts = res
                if not track:
                    placed_parts = None
                if cols.size:
                    t1 = time.perf_counter()
                    for f in [
                        runner.pool.submit(notify, s, cols, placed_parts)
                        for s in range(num_shards)
                    ]:
                        f.result()
                    runner.profile.add("merge", time.perf_counter() - t1)
        finally:
            runner.close()
        eng.telemetry.update(bstats.to_telemetry(self.strategy))
        runner.finalize_telemetry()


# ------------------------------------------------------------------- engine
class StreamEngine:
    """Drives one streaming pass: ``scorer.begin`` then ``policy.run``.

    ``ids`` overrides the stream order (otherwise computed from
    ``order``/``seed``); ``subpartitioner`` hooks CUTTANA's Def. 2
    sub-placement into every commit; ``on_chunk_end(engine, batch)`` runs
    after each chunk of the immediate policy (HeiStream's
    FM refinement): it may move the chunk's own vertices on the host, then
    must call ``engine.scorer.begin(engine.state)``; the engine writes the
    chunk's rows of ``part_of`` into the device mirror after it. The engine
    runs on the device of ``state.part_of_dev``. ``prefetch_enabled`` is
    whether chunks (and sharded admission scans) are decoded ahead on a
    prefetch thread, ``prefetch_ahead`` whether the sharded policies expand
    superstep t+1's frontier while t runs (:func:`_resolve_prefetch`).
    ``rows_route`` is whether the graph is memory-mapped, so that the
    kernels read each chunk's rows from a copy of them instead of a whole
    copy of the graph on the device."""

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
        on_chunk_end=None,
    ):
        self.graph = graph
        self.state = state
        self.scorer = scorer
        self.policy = policy
        self.subp = subpartitioner
        self.config = config or EngineConfig()
        self.ids = stream_order(graph, order, seed) if ids is None else ids
        self.on_chunk_end = on_chunk_end
        # run counters surfaced in PartitionResult.telemetry: kernel_calls
        # counts chunk-histogram calls, single_place_calls the host-scored
        # placements (buffered policy); policies add their own
        self.telemetry: dict = {"kernel_calls": 0, "single_place_calls": 0}
        self.prefetch_enabled, self.prefetch_ahead = _resolve_prefetch(
            self.config.prefetch, graph
        )
        self.prefetch_stats = PrefetchStats()
        self.device = state.device
        self.rows_route = is_mapped(graph)
        self._dgraph = None if self.rows_route else graph.to(self.device)
        self._ids_dev = torch.from_numpy(
            np.ascontiguousarray(self.ids, dtype=np.int64)
        ).to(self.device)
        self._zero_sizes = torch.zeros(state.k, dtype=torch.float32, device=self.device)
        self._pos = np.full(graph.num_vertices, -1, dtype=np.int64)
        # the sampled rows' draws (exact=False), the reference's stream
        self._sample_rng = np.random.default_rng(seed)

    def run(self) -> PartitionState:
        self.scorer.begin(self.state)
        self.policy.run(self)
        if self.prefetch_enabled:
            self.telemetry.update(self.prefetch_stats.to_telemetry())
        # a compressed indices proxy reports exact varint-decode wall time;
        # prefer it over the prefetcher's coarser fetch-wall aggregate
        decode_s = getattr(self.graph.indices, "decode_seconds", None)
        if decode_s is not None:
            self.telemetry["decode_wall_s"] = round(float(decode_s), 6)
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
        ``ids[start:start+C]`` from one gather-entry launch on the device
        (on the rows route: one copy of the chunk's packed rows, the third
        element of ``expanded``, and one rows-entry launch).

        Returns ``(hist, corr)``: ``hist`` is a list of C rows of K Python
        floats. ``corr`` is None in stale mode (``exact=False``), else
        ``(dst, starts)``: for chunk position ``i``,
        ``dst[starts[i]:starts[i+1]]`` lists the later chunk positions that
        have ``batch[i]`` as a neighbour - the rows to bump when ``batch[i]``
        is assigned.

        In stale mode the rows above ``sample_cap`` neighbours are scored on
        a sample: each draws ``sample_cap`` of its neighbours from
        ``_sample_rng`` (in row order, as the reference), their partitions
        go as one ``[s, width]`` matrix through ONE dense-entry launch
        (``width`` a power of two >= 8, padded with -1), and its rows replace
        those of the gather result, which is then cast to float64 and
        multiplied by ``degree / sample_cap``."""
        c = batch.shape[0]
        rows, cols = expanded[0], expanded[1]
        self.telemetry["kernel_calls"] += 1
        if self.rows_route:
            dev = expanded[2].to(self.device, non_blocking=True)
            local_indptr, cols_dev = _unpack_rows(dev, 0, c, cols.shape[0])
            hist = fennel_scores_rows(
                local_indptr, cols_dev, self.state.part_of_dev, self._zero_sizes, 0.0, 1.5
            )
        else:
            g = self._dgraph
            hist = fennel_scores_gather(
                g.indptr, g.indices, self.state.part_of_dev,
                self._ids_dev[start : start + c], self._zero_sizes, 0.0, 1.5,
            )
        cfg = self.config
        if cfg.exact:
            return hist.cpu().tolist(), self._inchunk_corr(batch, rows, cols)
        w = cfg.sample_cap
        indptr = self.graph.indptr
        degs = (indptr[batch + 1] - indptr[batch]).astype(np.int64)
        over = np.flatnonzero(degs > w)
        if over.size == 0:
            return hist.cpu().tolist(), None
        part_of = self.state.part_of  # the chunk-start state, as the mirror's
        first = np.cumsum(degs) - degs  # each row's first entry in cols
        width = max(8, 1 << (w - 1).bit_length())
        nbr_parts = np.full((over.size, width), -1, dtype=np.int32)
        scale = np.empty(over.size, dtype=np.float64)
        for j, i in enumerate(over.tolist()):
            nb = cols[first[i] : first[i] + degs[i]]
            sel = self._sample_rng.choice(nb.size, size=w, replace=False)
            nbr_parts[j, :w] = part_of[nb[sel]]
            scale[j] = nb.size / w
        hist[torch.from_numpy(over).to(self.device)] = fennel_scores(
            torch.from_numpy(nbr_parts).to(self.device), self._zero_sizes, 0.0, 1.5
        )
        out = hist.cpu().numpy().astype(np.float64)
        out[over] *= scale[:, None]
        return out.tolist(), None

    def flush_chunk(self, start: int, c: int, assigned) -> None:
        """Write a chunk's placements (a list or an array of C partitions)
        into the device mirror of ``part_of``."""
        vals = torch.as_tensor(assigned, dtype=torch.int32).to(self.device)
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
