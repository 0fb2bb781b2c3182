"""Seeded synthetic graph generators (port of ``repro.graph.generators``).

Every generator draws from numpy's PCG64 exactly as the reference does, so
the same seed gives byte-identical ``indptr``/``indices``:

  - ``rmat_graph``              -> social networks: power-law, low diameter.
  - ``powerlaw_cluster_graph``  -> web graphs: power-law, strong id-locality.
  - ``road_graph``              -> road networks: bounded degree, lattice.
  - ``ldbc_like_graph``         -> LDBC SNB: communities + power-law degrees.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.PCG64(seed))


def rmat_graph(
    num_vertices: int,
    avg_degree: float = 16.0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> CSRGraph:
    """R-MAT generator (Chakrabarti et al.) - power-law, social-network-like."""
    rng = _rng(seed)
    scale = int(np.ceil(np.log2(max(num_vertices, 2))))
    num_edges = int(num_vertices * avg_degree / 2)
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    # vectorised bit-by-bit quadrant sampling
    for bit in range(scale):
        r = rng.random(num_edges)
        go_right_src = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        go_right_dst = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= go_right_src.astype(np.int64) << bit
        dst |= go_right_dst.astype(np.int64) << bit
    # fold down into [0, num_vertices)
    src %= num_vertices
    dst %= num_vertices
    edges = np.stack([src, dst], axis=1)
    return CSRGraph.from_edges(edges, num_vertices=num_vertices)


def powerlaw_cluster_graph(
    num_vertices: int,
    avg_degree: float = 12.0,
    locality: float = 0.85,
    seed: int = 0,
) -> CSRGraph:
    """Web-graph-like: preferential attachment + strong id locality.

    Each new vertex v connects m = avg_degree/2 times; with prob ``locality``
    to a vertex in a nearby id window (crawl locality), otherwise by
    preferential attachment to earlier high-degree vertices (hubs).
    """
    rng = _rng(seed)
    m = max(1, int(round(avg_degree / 2)))
    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    # seed clique
    seed_n = m + 1
    sv, dv = np.triu_indices(seed_n, k=1)
    srcs.append(sv.astype(np.int64))
    dsts.append(dv.astype(np.int64))
    # degree-proportional sampling via an endpoint pool (BA trick)
    pool = np.concatenate([sv, dv]).astype(np.int64)
    pool_list = [pool]
    pool_size = pool.shape[0]
    batch = 4096
    v = seed_n
    while v < num_vertices:
        vb = min(batch, num_vertices - v)
        new_ids = np.arange(v, v + vb, dtype=np.int64)
        src_b = np.repeat(new_ids, m)
        r = rng.random(vb * m)
        # local edges: a window of ~1000 ids behind the new vertex
        window = np.minimum(new_ids, 1000)
        offs = (rng.random(vb * m) * np.repeat(window, m)).astype(np.int64) + 1
        local = src_b - offs
        # preferential edges: uniform sample from the endpoint pool
        flat_pool = np.concatenate(pool_list) if len(pool_list) > 1 else pool_list[0]
        pool_list = [flat_pool]
        pref = flat_pool[(rng.random(vb * m) * pool_size).astype(np.int64)]
        dst_b = np.where(r < locality, local, pref)
        srcs.append(src_b)
        dsts.append(dst_b)
        pool_list.append(np.concatenate([src_b, dst_b]))
        pool_size += src_b.shape[0] * 2
        v += vb
    edges = np.stack([np.concatenate(srcs), np.concatenate(dsts)], axis=1)
    return CSRGraph.from_edges(edges, num_vertices=num_vertices)


def road_graph(num_vertices: int, seed: int = 0, rewire: float = 0.01) -> CSRGraph:
    """Road-network-like: 2D lattice with sporadic shortcuts (degree ~4,
    enormous diameter, perfect id locality)."""
    rng = _rng(seed)
    side = int(np.ceil(np.sqrt(num_vertices)))
    ids = np.arange(num_vertices, dtype=np.int64)
    x = ids % side
    right = ids + 1
    right_ok = (x < side - 1) & (right < num_vertices)
    down = ids + side
    down_ok = down < num_vertices
    edges = np.concatenate(
        [
            np.stack([ids[right_ok], right[right_ok]], axis=1),
            np.stack([ids[down_ok], down[down_ok]], axis=1),
        ]
    )
    n_rewire = int(rewire * edges.shape[0])
    if n_rewire:
        extra = np.stack(
            [
                (rng.random(n_rewire) * num_vertices).astype(np.int64),
                (rng.random(n_rewire) * num_vertices).astype(np.int64),
            ],
            axis=1,
        )
        edges = np.concatenate([edges, extra])
    return CSRGraph.from_edges(edges, num_vertices=num_vertices)


def ldbc_like_graph(
    num_vertices: int,
    avg_degree: float = 18.0,
    num_communities: int | None = None,
    intra_prob: float = 0.7,
    seed: int = 0,
) -> CSRGraph:
    """LDBC-SNB-like social graph: communities of power-law size; each edge
    is intra-community with prob ``intra_prob``, else a zipf-skewed global
    target."""
    rng = _rng(seed)
    if num_communities is None:
        num_communities = max(4, num_vertices // 1500)
    # power-law community sizes
    raw = rng.zipf(1.6, size=num_communities).astype(np.float64)
    sizes = np.maximum(1, (raw / raw.sum() * num_vertices)).astype(np.int64)
    while sizes.sum() < num_vertices:
        sizes[rng.integers(num_communities)] += 1
    comm_of = np.repeat(np.arange(num_communities), sizes)[:num_vertices]
    comm_start = np.concatenate([[0], np.cumsum(sizes)])[:num_communities]
    comm_size = sizes

    num_edges = int(num_vertices * avg_degree / 2)
    src = (rng.random(num_edges) * num_vertices).astype(np.int64)
    intra = rng.random(num_edges) < intra_prob
    c = comm_of[src]
    intra_dst = comm_start[c] + (rng.random(num_edges) * comm_size[c]).astype(np.int64)
    intra_dst = np.minimum(intra_dst, num_vertices - 1)
    # global power-law targets
    zipf_draw = rng.zipf(1.3, size=num_edges) % num_vertices
    dst = np.where(intra, intra_dst, zipf_draw)
    edges = np.stack([src, dst], axis=1)
    return CSRGraph.from_edges(edges, num_vertices=num_vertices)


DATASETS = {
    # name -> (generator, kwargs); the same table as the reference
    "social-s": (rmat_graph, dict(num_vertices=20_000, avg_degree=16)),
    "social-m": (rmat_graph, dict(num_vertices=100_000, avg_degree=20)),
    "web-s": (powerlaw_cluster_graph, dict(num_vertices=20_000, avg_degree=12)),
    "web-m": (powerlaw_cluster_graph, dict(num_vertices=120_000, avg_degree=14)),
    "road-s": (road_graph, dict(num_vertices=25_000)),
    "road-m": (road_graph, dict(num_vertices=250_000)),
    "ldbc-s": (ldbc_like_graph, dict(num_vertices=30_000, avg_degree=18)),
}


def load_dataset(name: str, seed: int = 0) -> CSRGraph:
    gen, kwargs = DATASETS[name]
    return gen(seed=seed, **kwargs)
