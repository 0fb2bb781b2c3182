"""Streaming-clustering coarsening prepass, ``cluster+<algo>`` (port of
``repro.core.cluster``).

1. **Cluster** (:func:`streaming_cluster`) - one host pass over the stream
   order: each vertex joins the neighbouring cluster it shares the most
   edges with, under a volume cap and a member-count cap; vertices of
   degree >= ``hub_degree`` stay singletons. Each decision reads the ones
   before it, so the pass runs on the host, as in the reference.
2. **Contract** (:func:`build_coarse_graph`) - cross-cluster edges become
   the coarse edge list with multiplicity kept (``dedupe=False``), so the
   scorer's neighbour histograms count original edges. A supervertex row
   can hold up to ``cluster_cap_frac * 2|E| / k`` entries: the
   partition-score kernel's split-row path on real data.
3. **Partition** - ``cuttana`` or ``fennel`` streams the coarse graph on
   ``device`` (its gather-entry launches for ``fennel``).
4. **Project + repair** - ``part[v] = coarse_part[cluster_of[v]]``, then a
   deterministic greedy pass sheds lowest-degree vertices from
   over-capacity partitions (host).
5. **Refine** - CUTTANA's phase 2 (the sub-partition graph built on
   ``device``).

Telemetry: ``clusters_found``, ``coarsening_ratio``, ``coarse_edges``,
``repair_moves``, ``prepass_seconds`` plus the inner partitioner's own
counters.
"""
from __future__ import annotations

import time

import numpy as np

import torch

from repro_torch.core import cuttana as _cuttana
from repro_torch.core import fennel as _fennel
from repro_torch.core.cuttana import _phase2_refine
from repro_torch.core.subpartition import SubPartitioner
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.stream import stream_order

__all__ = [
    "streaming_cluster",
    "build_coarse_graph",
    "partition_cluster",
    "partition_cluster_cuttana",
    "partition_cluster_fennel",
]

_BASES = {"cuttana": None, "fennel": None}  # names validated up front


def streaming_cluster(
    graph,
    ids: np.ndarray,
    volume_cap: float,
    count_cap: int,
    hub_degree: int,
) -> tuple[np.ndarray, int, np.ndarray]:
    """Single-pass bounded-memory clustering in stream order.

    Returns ``(cluster_of, num_clusters, volumes)``. Deterministic: the
    candidate clusters are ranked by shared-edge count with ties to the
    smaller cluster id.
    """
    indptr, indices = graph.indptr, graph.indices
    n = graph.num_vertices
    cluster_of = np.full(n, -1, dtype=np.int64)
    vols: list[float] = []
    sizes: list[int] = []
    open_: list[bool] = []  # hub/isolated clusters are closed to joins
    nxt = 0
    for v in ids.tolist():
        lo, hi = int(indptr[v]), int(indptr[v + 1])
        deg = hi - lo
        if deg == 0 or deg >= hub_degree:
            cluster_of[v] = nxt
            vols.append(float(deg))
            sizes.append(1)
            open_.append(False)
            nxt += 1
            continue
        nc = cluster_of[indices[lo:hi]]
        nc = nc[nc >= 0]
        best = -1
        if nc.size:
            cids, counts = np.unique(nc, return_counts=True)
            # descending shared-edge count; np.unique returns ascending ids,
            # so a stable sort breaks count ties toward the smaller id
            for j in np.argsort(-counts, kind="stable").tolist():
                c = int(cids[j])
                if (
                    open_[c]
                    and vols[c] + deg <= volume_cap
                    and sizes[c] < count_cap
                ):
                    best = c
                    break
        if best < 0:
            best = nxt
            vols.append(0.0)
            sizes.append(0)
            open_.append(True)
            nxt += 1
        cluster_of[v] = best
        vols[best] += deg
        sizes[best] += 1
    return cluster_of, nxt, np.asarray(vols, dtype=np.float64)


def build_coarse_graph(
    graph, cluster_of: np.ndarray, num_clusters: int
) -> CSRGraph:
    """Contract clusters into supervertices, keeping cross-cluster edge
    multiplicity (``dedupe=False``) so coarse neighbour histograms weigh
    original edges."""
    src = np.repeat(
        np.arange(graph.num_vertices, dtype=np.int64),
        np.asarray(graph.degrees, dtype=np.int64),
    )
    cs = cluster_of[src]
    cd = cluster_of[graph.indices]
    keep = cs < cd  # each undirected cross-cluster edge once; intra dropped
    edges = np.stack([cs[keep], cd[keep]], axis=1)
    return CSRGraph.from_edges(edges, num_vertices=num_clusters, dedupe=False)


def _repair_balance(
    graph, part: np.ndarray, k: int, epsilon: float, balance_mode: str
) -> int:
    """Deterministic greedy repair of the fine-grained balance condition
    after projection: shed lowest-degree vertices from over-capacity
    partitions into the neighbour-richest partition with headroom.
    Mutates ``part`` in place; returns the number of moves."""
    degrees = np.asarray(graph.degrees, dtype=np.int64)
    n = graph.num_vertices
    if balance_mode == "vertex":
        mass = np.ones(n, dtype=np.float64)
        cap = (1.0 + epsilon) * n / k
    else:
        mass = degrees.astype(np.float64)
        cap = (1.0 + epsilon) * graph.indices.shape[0] / k
    loads = np.bincount(part, weights=mass, minlength=k)
    moves = 0
    for _ in range(5):  # ping-pong guard; one pass suffices in practice
        over = np.flatnonzero(loads > cap + 1e-9)
        if over.size == 0:
            break
        for p in over.tolist():
            members = np.flatnonzero(part == p)
            for v in members[np.argsort(degrees[members], kind="stable")].tolist():
                if loads[p] <= cap + 1e-9:
                    break
                m_v = mass[v]
                fits = loads + m_v <= cap + 1e-9
                fits[p] = False
                nbrs = graph.neighbors(v)
                hist = np.bincount(part[nbrs], minlength=k)
                if fits.any():
                    q = int(np.where(fits, hist, -1).argmax())
                else:
                    # a vertex too heavy for any headroom: least-loaded wins
                    masked = loads.copy()
                    masked[p] = np.inf
                    q = int(masked.argmin())
                part[v] = q
                loads[p] -= m_v
                loads[q] += m_v
                moves += 1
    return moves


def partition_cluster(
    graph,
    k: int,
    epsilon: float = 0.05,
    balance_mode: str = "edge",
    base: str = "cuttana",
    hub_degree: int = 1000,
    cluster_cap_frac: float = 0.1,
    use_refinement: bool = True,
    thresh: float = 0.0,
    subparts_per_partition: int | None = None,
    order: str = "natural",
    seed: int = 0,
    chunk: int = 512,
    telemetry: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Coarsen-stream-project-refine around any engine base partitioner.

    ``cluster_cap_frac`` bounds each cluster to that fraction of one
    partition's mass (degree volume AND vertex count), so the coarse
    instance always has enough movable units to balance; ``hub_degree``
    keeps high-degree vertices as singletons.
    """
    if base not in _BASES:
        raise ValueError(
            f"unknown cluster base {base!r}; expected one of {tuple(_BASES)}"
        )
    if not (0.0 < cluster_cap_frac <= 1.0):
        raise ValueError(
            f"cluster_cap_frac must be in (0, 1], got {cluster_cap_frac!r}"
        )
    device = resolve_device(device)
    n = graph.num_vertices
    t0 = time.perf_counter()
    ids = stream_order(graph, order, seed)
    volume_cap = max(cluster_cap_frac * graph.indices.shape[0] / k, 1.0)
    count_cap = max(int(cluster_cap_frac * n / k), 1)
    cluster_of, num_clusters, _ = streaming_cluster(
        graph, ids, volume_cap, count_cap, hub_degree
    )
    coarse = build_coarse_graph(graph, cluster_of, num_clusters)
    prepass_s = time.perf_counter() - t0

    inner_tel: dict = {}
    if base == "cuttana":
        coarse_part = _cuttana.partition(
            coarse, k, epsilon=epsilon, balance_mode=balance_mode,
            use_refinement=True, order=order, seed=seed, chunk=chunk,
            telemetry=inner_tel, device=device,
        )
    else:
        coarse_part = _fennel.partition(
            coarse, k, epsilon=epsilon, balance_mode=balance_mode,
            order=order, seed=seed, chunk=chunk, telemetry=inner_tel,
            device=device,
        )

    part = coarse_part[cluster_of].astype(np.int64)
    t1 = time.perf_counter()
    repair_moves = _repair_balance(graph, part, k, epsilon, balance_mode)

    moves, improvement = 0, 0.0
    if use_refinement and k > 1:
        if subparts_per_partition is None:
            subparts_per_partition = int(max(8, min(4096, n // (8 * k))))
        subp = SubPartitioner(
            graph, k, subparts_per_partition, balance_mode=balance_mode,
            seed=seed,
        )
        indptr, indices = graph.indptr, graph.indices
        for v in range(n):
            nbrs = indices[indptr[v] : indptr[v + 1]]
            subp.assign(v, int(part[v]), nbrs, nbrs.size)
        part, moves, improvement = _phase2_refine(
            graph, subp, k, epsilon, balance_mode, thresh, None, device
        )
    project_s = time.perf_counter() - t1

    if telemetry is not None:
        telemetry.update(inner_tel)
        telemetry.update(
            clusters_found=int(num_clusters),
            coarsening_ratio=float(num_clusters) / max(n, 1),
            coarse_edges=int(coarse.indices.shape[0] // 2),
            repair_moves=int(repair_moves),
            refine_moves=int(moves),
            refine_improvement=float(improvement),
            prepass_seconds=prepass_s,
            project_seconds=project_s,
            cluster_base=base,
        )
    return np.asarray(part, dtype=np.int32)


def partition_cluster_cuttana(graph, k: int, **kwargs) -> np.ndarray:
    """``cluster+cuttana``: coarsening prepass around CUTTANA."""
    return partition_cluster(graph, k, base="cuttana", **kwargs)


def partition_cluster_fennel(graph, k: int, **kwargs) -> np.ndarray:
    """``cluster+fennel``: coarsening prepass around FENNEL."""
    return partition_cluster(graph, k, base="fennel", **kwargs)
