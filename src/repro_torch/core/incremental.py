"""Incremental (re)partitioning under churn (port of
``repro.core.incremental``).

Edge-arrival batches (a :class:`~repro_torch.graph.churn.ChurnStream`) are
ingested one at a time:

1. newly seen vertices are placed by the streaming scorer (FENNEL Eq. 7
   against the hybrid mass) scored against the **live** partition loads;
   each batch builds its own :class:`~repro_torch.core.engine.StreamEngine`
   over a CSR of that batch's edges, uploaded to the device for the run,
   and its placements go through the partition-score kernel;
2. edge-cut drift lambda = cut/m is tracked per batch against a reference
   set at the last (re)stream;
3. when drift exceeds ``drift_threshold``, a *windowed local re-stream*
   re-places the most recently touched boundary vertices (at most
   ``window_frac`` of the seen graph) with full information, through
   ``ShardedImmediatePolicy(reassign=True)`` over the CSR of everything
   ingested.

The bookkeeping (edge keys, degrees, loads, drift, windows) is host numpy,
as in the reference; :class:`~repro_torch.core.priority.BufferStats` tracks
the window counts (``bypass`` = immediate placements, ``drained`` = window
re-streams, ``evictions`` = vertices moved). Registered as
``cuttana-incremental``: :func:`partition_incremental` replays a static
graph as a churn stream (one batch == the one-shot ``fennel`` run), and
:func:`update` warm-starts from a prior
:class:`~repro_torch.api.result.PartitionResult`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core.base import UNASSIGNED, FennelParams, PartitionState, finalize
from repro_torch.core.engine import (
    EngineConfig,
    FennelScorer,
    ShardedImmediatePolicy,
    StreamEngine,
    _check_num_shards,
)
from repro_torch.core.priority import BufferStats
from repro_torch.device import resolve_device
from repro_torch.graph.churn import ChurnStream, churn_from_graph
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.stream import stream_order

__all__ = ["IncrementalPartitioner", "partition_incremental", "update"]


class _GraphView:
    """The read surface :class:`FennelScorer` needs (``num_vertices``,
    ``num_edges``, ``indices.shape``) for the *currently seen* graph, without
    materializing it - alpha and mu track the live vertex/edge counts."""

    def __init__(self, num_vertices: int, num_edges: int):
        self.num_vertices = int(num_vertices)
        self.num_edges = int(num_edges)
        # O(1)-memory stand-in with the right shape (2|E| half-edges)
        self.indices = np.broadcast_to(
            np.int32(0), (max(2 * int(num_edges), 0),)
        )


class IncrementalPartitioner:
    """Stateful incremental partitioner over ``num_vertices`` vertex ids.

    ``ingest`` one edge batch at a time, then ``finalize`` to obtain the
    assignment (vertices never seen in any edge are placed onto the least
    loaded partition). ``num_shards`` >= 2 runs both new-vertex placement and
    re-stream windows through the bulk-synchronous superstep engine (one
    sharded-entry launch per superstep), ``num_shards=1`` through the
    sequential engine (one gather-entry launch per chunk); ``max_workers``
    changes wall-clock only, never assignments.

    Every engine run streams a CSR of this batch's edges (new vertices) or
    of everything ingested (re-stream windows), uploaded to ``device`` for
    that run; the device mirror ``state.part_of_dev`` is written by the
    engine with every placement, so it equals ``state.part_of`` before each
    launch.
    """

    def __init__(
        self,
        num_vertices: int,
        k: int,
        *,
        epsilon: float = 0.05,
        balance_mode: str = "edge",
        seed: int = 0,
        drift_threshold: float = 0.10,
        window_frac: float = 0.25,
        num_shards: int = 1,
        max_workers: int = 0,
        chunk: int = 512,
        device: str | torch.device | None = None,
    ):
        if balance_mode not in ("vertex", "edge"):
            raise ValueError(f"unknown balance mode {balance_mode}")
        if drift_threshold < 0:
            raise ValueError(
                f"drift_threshold must be >= 0, got {drift_threshold}"
            )
        if not (0 < window_frac <= 1):
            raise ValueError(
                f"window_frac must be in (0, 1], got {window_frac}"
            )
        self.n = int(num_vertices)
        self.k = int(k)
        self.seed = int(seed)
        self.drift_threshold = float(drift_threshold)
        self.window_frac = float(window_frac)
        self.num_shards = _check_num_shards(num_shards)
        self.max_workers = int(max_workers)
        self.chunk = int(chunk)
        self.params = FennelParams(hybrid=(balance_mode == "edge"))
        self.device = resolve_device(device)
        # live state: num_vertices/total_degree start at 0 and grow with the
        # stream, so the (1+eps)X/k capacities always reflect the seen graph
        self.state = PartitionState.from_arrays(
            np.full(self.n, UNASSIGNED, dtype=np.int32),
            np.zeros(self.k, dtype=np.float64),
            np.zeros(self.k, dtype=np.float64),
            k=self.k,
            total_degree=0,
            epsilon=float(epsilon),
            balance_mode=balance_mode,
            seed=seed,
            device=self.device,
        )
        self.state.num_vertices = 0
        self.seen = 0  # vertices with at least one ingested edge
        self.m = 0  # unique undirected edges ingested so far
        self.cut = 0  # exact cut-edge count under the current assignment
        self.deg = np.zeros(self.n, dtype=np.int64)
        self.last_touch = np.full(self.n, -1, dtype=np.int64)
        self._lo_blocks: list[np.ndarray] = []
        self._hi_blocks: list[np.ndarray] = []
        self._keys = np.empty(0, dtype=np.int64)  # sorted canonical edge keys
        self._ref: float | None = None  # lambda at the last (re)stream point
        self.stats = BufferStats()
        self.batches = 0
        self.restream_windows = 0
        self.moved_vertices = 0
        self.new_vertices = 0
        self.stream_work = 0  # total vertex placements (new + re-streamed)
        self.kernel_calls = 0
        self.drift_before: list[float] = []
        self.drift_after: list[float] = []

    # ------------------------------------------------------------- warm start
    @classmethod
    def from_partition(
        cls,
        graph: CSRGraph,
        assignment: np.ndarray,
        k: int,
        *,
        num_vertices: int | None = None,
        **kwargs,
    ) -> "IncrementalPartitioner":
        """Warm-start from a prior snapshot + assignment: the prior edges
        count as already streamed (zero additional work), loads/cut/drift
        reference are seeded from the assignment. ``num_vertices`` may exceed
        the prior graph to leave room for vertices the churn will add."""
        n = graph.num_vertices if num_vertices is None else int(num_vertices)
        if n < graph.num_vertices:
            raise ValueError(
                f"num_vertices={n} smaller than the prior graph "
                f"({graph.num_vertices})"
            )
        assignment = np.asarray(assignment)
        if assignment.shape != (graph.num_vertices,):
            raise ValueError(
                f"assignment shape {assignment.shape} != "
                f"({graph.num_vertices},)"
            )
        inc = cls(n, k, **kwargs)
        deg = graph.degrees.astype(np.int64)
        inc.state.part_of[: graph.num_vertices] = assignment
        inc.state.sync_mirror()  # once, before the first launch
        inc.state.v_counts[:] = np.bincount(assignment, minlength=k)
        inc.state.e_counts[:] = np.bincount(
            assignment, weights=deg.astype(np.float64), minlength=k
        )
        inc.deg[: graph.num_vertices] = deg
        inc.seen = graph.num_vertices  # isolated prior vertices are assigned
        inc.m = graph.num_edges
        inc.state.num_vertices = inc.seen
        inc.state.total_degree = 2 * inc.m
        edges = graph.edges_array()
        lo, hi = edges[:, 0], edges[:, 1]
        inc._lo_blocks.append(lo)
        inc._hi_blocks.append(hi)
        inc._keys = np.sort(lo * np.int64(inc.n) + hi)
        inc.cut = int((assignment[lo] != assignment[hi]).sum())
        inc._ref = inc.cut / max(inc.m, 1)
        inc.last_touch[: graph.num_vertices] = 0
        return inc

    # --------------------------------------------------------------- ingest
    def ingest(
        self, edges: np.ndarray, order_key: np.ndarray | None = None
    ) -> dict:
        """Ingest one edge-arrival batch; returns per-batch bookkeeping.

        Self loops and edges already ingested (in any earlier batch) are
        dropped. Newly seen vertices are placed in ascending id order, or by
        ``order_key[v]`` when given (how :func:`partition_incremental` honours
        the spec's stream order).
        """
        self.batches += 1
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        edges = edges[edges[:, 0] != edges[:, 1]]
        if edges.size and int(edges.max()) >= self.n:
            raise ValueError(
                f"edge endpoint {int(edges.max())} out of range for "
                f"num_vertices={self.n}"
            )
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        if lo.size:
            key = lo * np.int64(self.n) + hi
            _, first = np.unique(key, return_index=True)
            first.sort()
            lo, hi, key = lo[first], hi[first], key[first]
            if self._keys.size:
                pos = np.searchsorted(self._keys, key)
                pos_c = np.minimum(pos, self._keys.size - 1)
                fresh = (pos == self._keys.size) | (self._keys[pos_c] != key)
                lo, hi, key = lo[fresh], hi[fresh], key[fresh]
        if not lo.size:
            lam = self.cut / max(self.m, 1)
            return {"new_vertices": 0, "moved": 0, "edge_cut": lam}

        state = self.state
        ends = np.concatenate([lo, hi])
        new = np.unique(ends[state.part_of[ends] == UNASSIGNED])
        if order_key is not None and new.size:
            new = new[np.argsort(order_key[new], kind="stable")]
        # degree mass of edges landing on already-placed endpoints moves the
        # live loads *before* scoring; new endpoints add theirs on placement
        old_ends = ends[state.part_of[ends] != UNASSIGNED]
        if old_ends.size:
            np.add.at(
                state.e_counts,
                state.part_of[old_ends].astype(np.int64),
                1.0,
            )
        np.add.at(self.deg, lo, 1)
        np.add.at(self.deg, hi, 1)
        self.m += int(lo.size)
        self.seen += int(new.size)
        state.num_vertices = self.seen
        state.total_degree = 2 * self.m
        self._lo_blocks.append(lo)
        self._hi_blocks.append(hi)
        self._keys = np.sort(np.concatenate([self._keys, key]))

        if new.size:
            # a new vertex's batch row IS its whole adjacency so far, so the
            # batch-view CSR gives the scorer exact histograms for `new`
            batch_graph = CSRGraph.from_edges(
                np.stack([lo, hi], axis=1),
                num_vertices=self.n,
                dedupe=False,
            )
            self._run_engine(batch_graph, new.astype(np.int64), reassign=False)
            self.new_vertices += int(new.size)
            self.stream_work += int(new.size)
            self.stats.bypass += int(new.size)

        self.cut += int((state.part_of[lo] != state.part_of[hi]).sum())
        lam = self.cut / max(self.m, 1)
        moved = 0
        if self._ref is None:
            self._ref = lam
        elif lam > self._ref * (1.0 + self.drift_threshold):
            moved = self._restream(lam)
        else:
            self._ref = min(self._ref, lam)
        self.last_touch[np.unique(ends)] = self.batches
        return {
            "new_vertices": int(new.size),
            "moved": moved,
            "edge_cut": self.cut / max(self.m, 1),
        }

    # ------------------------------------------------------------- internals
    def _run_engine(
        self, graph: CSRGraph, ids: np.ndarray, reassign: bool
    ) -> None:
        engine = StreamEngine(
            graph,
            self.state,
            FennelScorer(
                _GraphView(self.seen, self.m),
                self.k,
                self.params,
                self.state.balance_mode,
            ),
            ShardedImmediatePolicy(self.num_shards, reassign=reassign),
            ids=ids,
            seed=self.seed,
            config=EngineConfig(chunk=self.chunk, max_workers=self.max_workers),
        )
        engine.run()
        self.kernel_calls += engine.telemetry["kernel_calls"]

    def _all_edges(self) -> tuple[np.ndarray, np.ndarray]:
        lo = (
            np.concatenate(self._lo_blocks)
            if self._lo_blocks
            else np.empty(0, dtype=np.int64)
        )
        hi = (
            np.concatenate(self._hi_blocks)
            if self._hi_blocks
            else np.empty(0, dtype=np.int64)
        )
        return lo, hi

    def _restream(self, lam: float) -> int:
        """Windowed local re-stream: re-place the most recently touched
        boundary vertices with full information. Returns vertices moved."""
        self.restream_windows += 1
        self.drift_before.append(float(lam))
        state = self.state
        lo, hi = self._all_edges()
        cut_mask = state.part_of[lo] != state.part_of[hi]
        cand = np.unique(np.concatenate([lo[cut_mask], hi[cut_mask]]))
        cap = max(1, int(np.ceil(self.window_frac * self.seen)))
        if cand.size > cap:
            # most recently touched first (drift lives where churn landed),
            # ties by ascending id; the selected window streams in id order
            recency = np.lexsort((cand, -self.last_touch[cand]))
            cand = np.sort(cand[recency][:cap])
        window = cand.astype(np.int64)
        if window.size:
            snapshot = CSRGraph.from_edges(
                np.stack([lo, hi], axis=1), num_vertices=self.n, dedupe=False
            )
            before = state.part_of[window].copy()
            self._run_engine(snapshot, window, reassign=True)
            moved = int((state.part_of[window] != before).sum())
        else:
            moved = 0
        self.moved_vertices += moved
        self.stream_work += int(window.size)
        self.stats.drained += int(window.size)
        self.stats.evictions += moved
        self.stats.observe_len(int(window.size))
        self.cut = int((state.part_of[lo] != state.part_of[hi]).sum())
        lam_after = self.cut / max(self.m, 1)
        self._ref = lam_after
        self.drift_after.append(float(lam_after))
        return moved

    # -------------------------------------------------------------- finalize
    def finalize(self) -> np.ndarray:
        """Assign any never-seen (isolated) vertices to the least loaded
        partition and return the full int32 assignment."""
        state = self.state
        isolated = np.flatnonzero(state.part_of == UNASSIGNED)
        for v in isolated:
            state.assign(int(v), int(state.v_counts.argmin()), 0)
        if isolated.size:
            state.part_of_dev[torch.from_numpy(isolated).to(self.device)] = (
                torch.from_numpy(state.part_of[isolated]).to(self.device)
            )
        self.stream_work += int(isolated.size)
        self.seen = self.n
        state.num_vertices = self.n
        return finalize(state)

    def snapshot_graph(self) -> CSRGraph:
        """The static CSR graph of everything ingested so far."""
        lo, hi = self._all_edges()
        return CSRGraph.from_edges(
            np.stack([lo, hi], axis=1), num_vertices=self.n, dedupe=False
        )

    def telemetry(self) -> dict:
        out = {
            "batches": self.batches,
            "restream_windows": self.restream_windows,
            "moved_vertices": self.moved_vertices,
            "new_vertices": self.new_vertices,
            "stream_work": self.stream_work,
            "kernel_calls": self.kernel_calls,
            "edge_cut_live": self.cut / max(self.m, 1),
            "drift_before": [round(x, 6) for x in self.drift_before],
            "drift_after": [round(x, 6) for x in self.drift_after],
            "num_shards": self.num_shards,
        }
        out.update(self.stats.to_telemetry("incremental-window"))
        return out


def _resolve_shards(num_shards: int, chunk: int, num_vertices: int) -> int:
    if int(num_shards) == 0:
        num_shards = autotune.resolve(
            0, chunk, algo="restream", num_vertices=num_vertices
        ).num_shards
    return _check_num_shards(num_shards)


def partition_incremental(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    order: str = "natural",
    seed: int = 0,
    num_batches: int = 16,
    drift_threshold: float = 0.10,
    window_frac: float = 0.25,
    num_shards: int = 1,
    max_workers: int = 0,
    chunk: int = 512,
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """``cuttana-incremental``: replay ``graph`` as a churn stream.

    The static graph is converted to an arrival stream via
    :func:`~repro_torch.graph.churn.churn_from_graph` under the spec's
    ``order``/``seed`` and ingested in ``num_batches`` batches. With
    ``num_batches=1`` (and no isolated vertices) this is *exactly* the
    one-shot FENNEL streaming run - the parity pin - while larger batch
    counts exercise the live-load placement + drift-triggered re-stream path
    the ``update`` API uses on real churn.
    """
    if num_batches < 1:
        raise ValueError(f"num_batches must be >= 1, got {num_batches}")
    num_shards = _resolve_shards(num_shards, chunk, graph.num_vertices)
    t0 = time.perf_counter()
    stream = churn_from_graph(graph, order=order, seed=seed)
    pos = np.empty(graph.num_vertices, dtype=np.int64)
    pos[stream_order(graph, order, seed)] = np.arange(
        graph.num_vertices, dtype=np.int64
    )
    inc = IncrementalPartitioner(
        graph.num_vertices,
        k,
        epsilon=epsilon,
        balance_mode=balance_mode,
        seed=seed,
        drift_threshold=drift_threshold,
        window_frac=window_frac,
        num_shards=num_shards,
        max_workers=max_workers,
        chunk=chunk,
        device=device,
    )
    for batch in stream.batches(num_batches):
        inc.ingest(batch, order_key=pos)
    part = inc.finalize()
    if telemetry is not None:
        telemetry.update(inc.telemetry())
        telemetry["stream_seconds"] = time.perf_counter() - t0
    return part


def update(
    prior,
    batches,
    *,
    k: int | None = None,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    seed: int = 0,
    num_batches: int = 16,
    drift_threshold: float = 0.10,
    window_frac: float = 0.25,
    num_shards: int = 1,
    max_workers: int = 0,
    chunk: int = 512,
    device: str | torch.device | None = None,
):
    """Incrementally update a partition with new edge arrivals.

    ``prior`` is a :class:`~repro_torch.api.result.PartitionResult` (its
    spec supplies k/epsilon/balance_mode/seed defaults, its ``device`` the
    device unless ``device`` is given), a ``(graph, assignment)`` pair, or
    ``None`` for a cold start. ``batches`` is a
    :class:`~repro_torch.graph.churn.ChurnStream` (replayed in
    ``num_batches`` arrival batches) or an iterable of ``(m_i, 2)`` edge
    arrays.

    Returns a new :class:`~repro_torch.api.result.PartitionResult` over the
    post-churn snapshot graph, with the incremental telemetry
    (``batches``/``restream_windows``/``moved_vertices``/``drift_*``) and
    ``timings["stream_seconds"]`` covering only the update work.
    """
    from repro_torch.api.result import PartitionResult
    from repro_torch.api.spec import PartitionSpec

    prior_graph, prior_assignment = None, None
    if prior is not None:
        if hasattr(prior, "assignment") and hasattr(prior, "spec"):
            prior_graph, prior_assignment = prior.graph, prior.assignment
            if device is None:
                device = prior.device
            spec = prior.spec
            k = spec.k if k is None else k
            epsilon, balance_mode, seed = (
                spec.epsilon, spec.balance_mode, spec.seed,
            )
        else:
            prior_graph, prior_assignment = prior
    if k is None:
        raise ValueError("update() needs k (from the prior result or k=...)")

    if isinstance(batches, ChurnStream):
        batch_list = batches.batches(num_batches)
        churn_n = batches.num_vertices
    else:
        batch_list = [
            np.asarray(b, dtype=np.int64).reshape(-1, 2) for b in batches
        ]
        churn_n = max(
            (int(b.max()) + 1 for b in batch_list if b.size), default=0
        )
    n = max(churn_n, prior_graph.num_vertices if prior_graph is not None else 0)
    num_shards = _resolve_shards(num_shards, chunk, n)
    device = resolve_device(device)
    knobs = dict(
        epsilon=epsilon,
        balance_mode=balance_mode,
        seed=seed,
        drift_threshold=drift_threshold,
        window_frac=window_frac,
        num_shards=num_shards,
        max_workers=max_workers,
        chunk=chunk,
        device=device,
    )
    t0 = time.perf_counter()
    if prior_graph is not None:
        inc = IncrementalPartitioner.from_partition(
            prior_graph, prior_assignment, k, num_vertices=n, **knobs
        )
    else:
        inc = IncrementalPartitioner(n, k, **knobs)
    for batch in batch_list:
        inc.ingest(batch)
    part = inc.finalize()
    stream_s = time.perf_counter() - t0
    snapshot = inc.snapshot_graph()
    spec = PartitionSpec(
        algo="cuttana-incremental",
        k=k,
        epsilon=epsilon,
        balance_mode=balance_mode,
        seed=seed,
        params={
            "num_batches": max(len(batch_list), 1),
            "drift_threshold": drift_threshold,
            "window_frac": window_frac,
            "num_shards": num_shards,
            "max_workers": max_workers,
            "chunk": chunk,
        },
    )
    telemetry = inc.telemetry()
    telemetry.update(
        graph_backing="resident",
        peak_graph_bytes=int(snapshot.indptr.nbytes + snapshot.indices.nbytes),
        mapped_graph_bytes=0,
        compressed_graph_bytes=0,
        warm_start=prior_graph is not None,
        device=str(device),
    )
    return PartitionResult(
        spec=spec,
        graph=snapshot,
        assignment=part,
        device=device,
        timings={"total_s": stream_s, "stream_seconds": stream_s},
        telemetry=telemetry,
    )
