"""Timestamped edge-arrival streams for incremental partitioning (port of
``repro.graph.churn``).

A :class:`ChurnStream` is the dynamic-graph counterpart of a static
:class:`~repro_torch.graph.csr.CSRGraph`: an ordered, deduplicated edge list
with nondecreasing arrival timestamps. :mod:`repro_torch.core.incremental`
replays it in batches. Streams live on the host in numpy, and their ``.npz``
form is the reference's, so a stream saved by one package loads in the other.

* :func:`rmat_churn` - an R-MAT graph whose edges arrive over time, in
  ``"growth"`` order (vertices join one by one with their back-edges) or
  fully ``"random"``;
* :func:`churn_from_graph` - an arrival order for an existing graph from a
  stream order (``natural``/``random``/``bfs``/``dfs``), so an incremental
  replay of the whole stream is comparable to a one-shot run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.stream import stream_order

__all__ = ["ChurnStream", "rmat_churn", "churn_from_graph"]


@dataclasses.dataclass(frozen=True)
class ChurnStream:
    """An ordered stream of unique undirected edges with arrival times.

    Attributes:
      edges:      int64[m, 2] canonical ``(lo, hi)`` endpoint pairs in
                  arrival order - no self-loops, each undirected edge once
                  (the first arrival wins; later duplicates are dropped).
      timestamps: float64[m] nondecreasing arrival times.
      num_vertices: size of the vertex id space (ids are ``< num_vertices``).
    """

    edges: np.ndarray
    timestamps: np.ndarray
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    # ------------------------------------------------------------ construction
    @staticmethod
    def from_edges(
        edges: np.ndarray,
        timestamps: np.ndarray | None = None,
        num_vertices: int | None = None,
    ) -> "ChurnStream":
        """Canonicalize a raw timestamped edge list into a stream.

        Rows are stably sorted by timestamp (given order breaks ties), self
        loops are dropped, and duplicate undirected edges keep only their
        first arrival. Without timestamps the given order *is* the arrival
        order and timestamps become ``0, 1, 2, ...``.
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if timestamps is None:
            ts = np.arange(edges.shape[0], dtype=np.float64)
        else:
            ts = np.asarray(timestamps, dtype=np.float64).reshape(-1)
            if ts.shape[0] != edges.shape[0]:
                raise ValueError(
                    f"timestamps length {ts.shape[0]} != edges length "
                    f"{edges.shape[0]}"
                )
            order = np.argsort(ts, kind="stable")
            edges, ts = edges[order], ts[order]
        keep = edges[:, 0] != edges[:, 1]  # no self loops
        edges, ts = edges[keep], ts[keep]
        if num_vertices is None:
            num_vertices = int(edges.max()) + 1 if edges.size else 0
        elif edges.size and int(edges.max()) >= num_vertices:
            raise ValueError(
                f"edge endpoint {int(edges.max())} out of range for "
                f"num_vertices={num_vertices}"
            )
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        if edges.size:
            key = lo * np.int64(num_vertices) + hi
            _, first = np.unique(key, return_index=True)
            first.sort()  # keep first arrivals, in arrival order
            lo, hi, ts = lo[first], hi[first], ts[first]
        return ChurnStream(
            edges=np.stack([lo, hi], axis=1),
            timestamps=ts,
            num_vertices=int(num_vertices),
        )

    # ---------------------------------------------------------------- replay
    def batches(self, num_batches: int) -> list[np.ndarray]:
        """Split the stream into ``num_batches`` near-equal arrival batches
        (earliest first). Trailing batches may be empty for tiny streams."""
        if num_batches < 1:
            raise ValueError(f"num_batches must be >= 1, got {num_batches}")
        return np.array_split(self.edges, num_batches)

    def windows(self, span: float) -> list[np.ndarray]:
        """Split by time instead of count: consecutive ``span``-wide windows
        starting at the first timestamp. Empty windows are preserved so the
        replay cadence matches wall time."""
        if span <= 0:
            raise ValueError(f"span must be > 0, got {span}")
        if self.num_edges == 0:
            return []
        t0 = float(self.timestamps[0])
        n_win = int(np.floor((float(self.timestamps[-1]) - t0) / span)) + 1
        bounds = t0 + span * np.arange(1, n_win)
        cuts = np.searchsorted(self.timestamps, bounds, side="left")
        return np.split(self.edges, cuts)

    def final_graph(self) -> CSRGraph:
        """The static graph after the whole stream has arrived."""
        return CSRGraph.from_edges(
            self.edges, num_vertices=self.num_vertices, dedupe=False
        )

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            edges=self.edges,
            timestamps=self.timestamps,
            num_vertices=np.int64(self.num_vertices),
        )

    @staticmethod
    def load(path: str) -> "ChurnStream":
        data = np.load(path)
        return ChurnStream(
            edges=data["edges"],
            timestamps=data["timestamps"],
            num_vertices=int(data["num_vertices"]),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ChurnStream(|V|={self.num_vertices}, m={self.num_edges}, "
            f"t=[{self.timestamps[0] if self.num_edges else 0:.3g}, "
            f"{self.timestamps[-1] if self.num_edges else 0:.3g}])"
        )


def rmat_churn(
    num_vertices: int,
    avg_degree: float = 16.0,
    seed: int = 0,
    ordering: str = "growth",
) -> ChurnStream:
    """Synthesize a churn stream from a seeded R-MAT graph.

    ``ordering="growth"`` models a growing network: edges arrive grouped by
    their later-joining endpoint (seeded shuffle within each group), so a
    vertex's whole back-edge set lands when the vertex first appears.
    ``ordering="random"`` is a seeded uniform shuffle of the edge list -
    the adversarial case where a vertex's edges are scattered across the
    whole stream.
    """
    from repro_torch.graph.generators import rmat_graph

    graph = rmat_graph(num_vertices, avg_degree=avg_degree, seed=seed)
    edges = graph.edges_array()
    rng = np.random.default_rng(seed + 1)
    jitter = rng.permutation(edges.shape[0])
    if ordering == "growth":
        order = np.lexsort((jitter, np.maximum(edges[:, 0], edges[:, 1])))
    elif ordering == "random":
        order = jitter
    else:
        raise ValueError(
            f'ordering must be "growth" or "random", got {ordering!r}'
        )
    return ChurnStream.from_edges(
        edges[order], num_vertices=graph.num_vertices
    )


def churn_from_graph(
    graph: CSRGraph, order: str = "natural", seed: int = 0
) -> ChurnStream:
    """Derive an arrival stream for an existing graph from a stream order.

    An edge arrives when its *later* endpoint (by the vertex stream order)
    does, ties broken by the earlier endpoint's position - exactly the edge
    information a one-shot streaming partitioner has seen by the time it
    places that vertex. Replaying this stream as a single batch therefore
    feeds the incremental partitioner the same vertex order and the same
    neighbourhoods as the one-shot run.
    """
    so = stream_order(graph, order, seed)
    pos = np.empty(graph.num_vertices, dtype=np.int64)
    pos[so] = np.arange(graph.num_vertices, dtype=np.int64)
    edges = graph.edges_array()
    pu, pv = pos[edges[:, 0]], pos[edges[:, 1]]
    arrival = np.lexsort((np.minimum(pu, pv), np.maximum(pu, pv)))
    return ChurnStream.from_edges(
        edges[arrival], num_vertices=graph.num_vertices
    )
