"""The reference's seed per-vertex loops (port of ``repro.core.legacy``),
registered as the ``*-legacy`` algorithms: parity baselines for the
engine-backed partitioners.

The FENNEL, LDG, CUTTANA and HeiStream loops place one vertex at a time,
each placement reading the one before it, so they run on the host in numpy,
as in the reference. ``cuttana_batched_partition`` histograms each chunk
with one dense-entry launch of the partition-score kernel on ``device``,
seeded by its own ``default_rng(seed)``; the CUTTANA loops build their
phase-2 sub-partition graph on ``device``. Keep the loops as they are:
their value is being a fixed reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.base import (
    FennelParams,
    PartitionState,
    finalize,
    make_fennel_score,
)
from repro_torch.core.buffer import PriorityBuffer
from repro_torch.core.refinement import Refiner, build_subpartition_graph
from repro_torch.core.subpartition import phase2_subpartitioner
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.stream import stream_order
from repro_torch.kernels.partition_score.ops import fennel_scores

__all__ = [
    "fennel_partition",
    "ldg_partition",
    "cuttana_partition",
    "cuttana_batched_partition",
    "heistream_partition",
    "restream_partition",
]

# the per-vertex loops keep their state on the host; its device mirror is
# never read, so it stays in host memory
_HOST = torch.device("cpu")


# ------------------------------------------------------------------- FENNEL
def fennel_partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "vertex",
    params: FennelParams | None = None,
    order: str = "natural",
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    params = params or FennelParams()
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=_HOST)
    score_fn = make_fennel_score(graph, k, params, balance_mode)
    indptr, indices = graph.indptr, graph.indices
    for v in stream_order(graph, order, seed):
        nbrs = indices[indptr[v] : indptr[v + 1]]
        hist = state.neighbor_histogram(nbrs)
        scores = score_fn(state, hist)
        allowed = ~state.would_overflow(nbrs.size)
        p = state.argmax_tiebreak(scores, allowed)
        state.assign(int(v), p, nbrs.size)
    return finalize(state)


# ---------------------------------------------------------------------- LDG
def ldg_partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "vertex",
    order: str = "natural",
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=_HOST)
    indptr, indices = graph.indptr, graph.indices
    for v in stream_order(graph, order, seed):
        nbrs = indices[indptr[v] : indptr[v + 1]]
        hist = state.neighbor_histogram(nbrs)
        if balance_mode == "vertex":
            frac = state.v_counts / state.vertex_capacity
        else:
            frac = state.e_counts / state.edge_capacity
        scores = hist * np.maximum(1.0 - frac, 0.0)
        loads = state.v_counts if balance_mode == "vertex" else state.e_counts
        scores = scores - 1e-9 * loads
        allowed = ~state.would_overflow(nbrs.size)
        p = state.argmax_tiebreak(scores, allowed)
        state.assign(int(v), p, nbrs.size)
    return finalize(state)


# ------------------------------------------------------------------ CUTTANA
def cuttana_partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    d_max: int = 1000,
    max_qsize: int | None = None,
    theta: float = 1.0,
    subparts_per_partition: int | None = None,
    use_buffer: bool = True,
    use_refinement: bool = True,
    thresh: float = 0.0,
    max_moves: int | None = None,
    fennel_params: FennelParams | None = None,
    order: str = "natural",
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Seed CUTTANA (Algorithm 1 + phase-2), sequential per-vertex loop;
    the sub-partition graph of phase 2 is built on ``device``."""
    device = resolve_device(device)
    n = graph.num_vertices
    if max_qsize is None:
        max_qsize = max(1024, n // 10)
    if subparts_per_partition is None:
        subparts_per_partition = int(max(8, min(4096, n // (8 * k))))

    params = fennel_params or FennelParams(hybrid=(balance_mode == "edge"))
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=_HOST)
    score_fn = make_fennel_score(graph, k, params, balance_mode)
    refine = use_refinement and k > 1
    subp = phase2_subpartitioner(
        graph, k, subparts_per_partition, refine, epsilon, balance_mode, seed
    )
    indptr, indices = graph.indptr, graph.indices
    buf = PriorityBuffer(max_qsize, d_max, theta)

    def place(v: int, nbrs: np.ndarray) -> None:
        worklist = [(v, nbrs)]
        while worklist:
            u, un = worklist.pop()
            hist = state.neighbor_histogram(un)
            scores = score_fn(state, hist)
            allowed = ~state.would_overflow(un.size)
            p = state.argmax_tiebreak(scores, allowed)
            state.assign(u, p, un.size)
            if subp is not None:
                subp.assign(u, p, un, un.size)
            for w in un:
                wi = int(w)
                if buf.contains(wi) and buf.notify_assigned(wi):
                    worklist.append((wi, buf.remove(wi)))

    if not use_buffer:
        for v in stream_order(graph, order, seed):
            place(int(v), indices[indptr[v] : indptr[v + 1]])
    else:
        for v in stream_order(graph, order, seed):
            v = int(v)
            if state.part_of[v] != -1:
                continue
            nbrs = indices[indptr[v] : indptr[v + 1]]
            if nbrs.size >= d_max:
                place(v, nbrs)
                continue
            assigned = int((state.part_of[nbrs] != -1).sum())
            if assigned == nbrs.size and nbrs.size > 0:
                place(v, nbrs)
                continue
            buf.push(v, nbrs, assigned)
            if buf.full:
                u, un = buf.pop_best()
                place(u, un)
        while len(buf):
            u, un = buf.pop_best()
            place(u, un)

    part = finalize(state)
    if refine:
        w = build_subpartition_graph(graph, subp.sub_of, subp.kp, device).cpu().numpy()
        sub_part = np.repeat(np.arange(k, dtype=np.int64), subp.s)
        if balance_mode == "edge":
            size, total = subp.sub_e_counts.copy(), float(graph.indices.shape[0])
        else:
            size, total = subp.sub_v_counts.copy(), float(n)
        refiner = Refiner(w, sub_part, size, k, epsilon, total_mass=total)
        refiner.refine(thresh=thresh, max_moves=max_moves)
        part = refiner.sub_part[subp.sub_of].astype(np.int32)
    return part


# ---------------------------------------------------------- CUTTANA batched
def cuttana_batched_partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    chunk: int = 512,
    sample_cap: int = 512,
    use_refinement: bool = True,
    subparts_per_partition: int | None = None,
    thresh: float = 0.0,
    order: str = "natural",
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Seed chunk-parallel variant: kernel histograms, stale by one chunk.
    Each chunk's ``[C, width]`` matrix of neighbour partitions goes through
    one dense-entry launch of the partition-score kernel on ``device``."""
    device = resolve_device(device)
    n = graph.num_vertices
    m = max(graph.num_edges, 1)
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=_HOST)
    if subparts_per_partition is None:
        subparts_per_partition = int(max(8, min(4096, n // (8 * k))))
    refine = use_refinement and k > 1
    subp = phase2_subpartitioner(
        graph, k, subparts_per_partition, refine, epsilon, balance_mode, seed
    )
    params = FennelParams(hybrid=(balance_mode == "edge"))
    alpha = params.alpha_scale * np.sqrt(k) * m / (max(n, 1) ** 1.5)
    gamma = params.gamma
    mu = n / max(graph.indices.shape[0], 1)
    rng = np.random.default_rng(seed)
    indptr, indices = graph.indptr, graph.indices
    ids = stream_order(graph, order, seed)
    sizes = torch.zeros(k, dtype=torch.float32, device=device)

    for start in range(0, n, chunk):
        batch = ids[start : start + chunk]
        c = len(batch)
        degs = (indptr[batch + 1] - indptr[batch]).astype(np.int64)
        width = int(min(max(degs.max(), 1), sample_cap))
        nbr_parts = np.full((c, width), -1, dtype=np.int32)
        scale = np.ones(c, dtype=np.float64)
        nbr_cache: list[np.ndarray] = []
        for i, v in enumerate(batch):
            nb = indices[indptr[v] : indptr[v + 1]]
            nbr_cache.append(nb)
            if nb.size > width:
                sel = rng.choice(nb.size, size=width, replace=False)
                nbp = state.part_of[nb[sel]]
                scale[i] = nb.size / width
            else:
                nbp = state.part_of[nb]
            nbr_parts[i, : nbp.size] = nbp
        hist = fennel_scores(
            torch.from_numpy(nbr_parts).to(device), sizes, 0.0, gamma
        ).cpu().numpy().astype(np.float64) * scale[:, None]
        for i, v in enumerate(batch):
            if params.hybrid:
                size = 0.5 * (state.v_counts + mu * state.e_counts)
            else:
                size = state.v_counts
            scores = hist[i] - alpha * gamma * np.power(
                np.maximum(size, 0.0), gamma - 1.0
            )
            allowed = ~state.would_overflow(int(degs[i]))
            p = state.argmax_tiebreak(scores, allowed)
            state.assign(int(v), p, int(degs[i]))
            if subp is not None:
                subp.assign(int(v), p, nbr_cache[i], int(degs[i]))

    part = finalize(state)
    if refine:
        w = build_subpartition_graph(graph, subp.sub_of, subp.kp, device).cpu().numpy()
        sub_part = np.repeat(np.arange(k, dtype=np.int64), subp.s)
        if balance_mode == "edge":
            size, total = subp.sub_e_counts, float(graph.indices.shape[0])
        else:
            size, total = subp.sub_v_counts, float(n)
        r = Refiner(w, sub_part, size, k, epsilon, total_mass=total)
        r.refine(thresh=thresh)
        part = r.sub_part[subp.sub_of].astype(np.int32)
    return part


# ---------------------------------------------------------------- HeiStream
def heistream_partition(
    graph: CSRGraph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "vertex",
    batch_size: int = 4096,
    fm_passes: int = 3,
    order: str = "natural",
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    state = PartitionState.create(graph, k, epsilon, balance_mode, seed, device=_HOST)
    score_fn = make_fennel_score(
        graph, k, FennelParams(hybrid=(balance_mode == "edge")), balance_mode
    )
    indptr, indices = graph.indptr, graph.indices
    rng = np.random.default_rng(seed)
    ids = stream_order(graph, order, seed)

    for start in range(0, len(ids), batch_size):
        batch = [int(v) for v in ids[start : start + batch_size]]
        nbrs_of = {v: indices[indptr[v] : indptr[v + 1]] for v in batch}
        for v in batch:
            nbrs = nbrs_of[v]
            hist = state.neighbor_histogram(nbrs)
            scores = score_fn(state, hist)
            allowed = ~state.would_overflow(nbrs.size)
            p = state.argmax_tiebreak(scores, allowed)
            state.assign(v, p, nbrs.size)
        for _ in range(fm_passes):
            moved = 0
            for v in rng.permutation(batch):
                v = int(v)
                nbrs = nbrs_of[v]
                deg = nbrs.size
                cur = int(state.part_of[v])
                hist = state.neighbor_histogram(nbrs)
                gains = hist - hist[cur]
                if balance_mode == "vertex":
                    over = state.v_counts + 1 > state.vertex_capacity
                else:
                    over = state.e_counts + deg > state.edge_capacity
                over[cur] = False
                gains = np.where(over, -np.inf, gains)
                best = int(gains.argmax())
                if best != cur and gains[best] > 0:
                    state.part_of[v] = best
                    state.v_counts[cur] -= 1
                    state.v_counts[best] += 1
                    state.e_counts[cur] -= deg
                    state.e_counts[best] += deg
                    moved += 1
            if moved == 0:
                break
    return finalize(state)


# ---------------------------------------------------------------- restream
def restream_partition(
    graph: CSRGraph,
    k: int,
    passes: int = 3,
    base: str = "cuttana",
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    final_refine: bool = True,
    order: str = "random",
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    from repro_torch.api.registry import get_info
    from repro_torch.core.cuttana import refine_any

    device = resolve_device(device)
    part = get_info(base, kind="edge-cut").resolve()(
        graph, k, epsilon=epsilon, balance_mode=balance_mode,
        order=order, seed=seed, device=device,
    )
    indptr, indices = graph.indptr, graph.indices
    deg = graph.degrees
    params = FennelParams(hybrid=(balance_mode == "edge"))
    for p in range(1, passes):
        state = PartitionState.create(
            graph, k, epsilon, balance_mode, seed + p, device=_HOST
        )
        state.part_of[:] = part
        state.v_counts[:] = np.bincount(part, minlength=k)
        state.e_counts[:] = np.bincount(
            part, weights=deg.astype(np.float64), minlength=k
        )
        score_fn = make_fennel_score(graph, k, params, balance_mode)
        for v in stream_order(graph, order, seed + p):
            v = int(v)
            d = int(deg[v])
            cur = int(state.part_of[v])
            state.v_counts[cur] -= 1
            state.e_counts[cur] -= d
            nbrs = indices[indptr[v] : indptr[v + 1]]
            hist = state.neighbor_histogram(nbrs)
            scores = score_fn(state, hist)
            allowed = ~state.would_overflow(d)
            allowed[cur] = True
            new = state.argmax_tiebreak(scores, allowed)
            state.part_of[v] = new
            state.v_counts[new] += 1
            state.e_counts[new] += d
        part = state.part_of.copy()
    if final_refine and k > 1:
        part = refine_any(
            graph, part, k, epsilon=epsilon, balance_mode=balance_mode,
            seed=seed, device=device,
        )
    return part
