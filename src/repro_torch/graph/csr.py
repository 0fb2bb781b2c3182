"""Compressed-sparse-row graph structure (port of ``repro.graph.csr``).

The graph lives on the host in numpy, exactly as in the reference, because
the streaming loops read neighbour rows one chunk at a time on the host.
:meth:`CSRGraph.to` places ``indptr`` (int64[|V|+1]) and ``indices``
(int32[2|E|]) on a device once; the kernels, the sub-partition graph build
and the quality scans read that copy. A memory-mapped graph
(:class:`~repro_torch.graph.external.ExternalCSRGraph`) has no such copy.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """The CSR arrays of one graph on one device."""

    indptr: torch.Tensor  # int64[|V|+1]
    indices: torch.Tensor  # int32[2|E|]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def sources(self) -> torch.Tensor:
        """int64[2|E|]: the row (source vertex) of every CSR entry."""
        n = self.indptr.shape[0] - 1
        return torch.repeat_interleave(
            torch.arange(n, dtype=torch.int64, device=self.device),
            self.degrees(),
            output_size=self.indices.shape[0],
        )


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Undirected graph in CSR form, stored symmetrically.

    Attributes:
      indptr:  int64[|V|+1] row offsets into ``indices``.
      indices: int32[2|E|]  neighbour ids, symmetric (u in N(v) <=> v in N(u)).
    """

    indptr: np.ndarray
    indices: np.ndarray
    _on_device: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    # ---------------------------------------------------------------- basics
    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        """Number of undirected edges (each counted once)."""
        return int(self.indices.shape[0] // 2)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def iter_adjacency(
        self, order: Sequence[int] | None = None
    ) -> Iterator[tuple[int, np.ndarray]]:
        """Yield ``(v, N(v))`` in the given stream order (default: natural)."""
        ids = range(self.num_vertices) if order is None else order
        for v in ids:
            yield int(v), self.neighbors(int(v))

    def edges_array(self) -> np.ndarray:
        """(|E|, 2) array with each undirected edge listed once (u < v), in
        CSR order - the order vertex-cut ``edge_part`` arrays index."""
        src = np.repeat(np.arange(self.num_vertices, dtype=np.int64), self.degrees)
        dst = self.indices.astype(np.int64)
        mask = src < dst
        return np.stack([src[mask], dst[mask]], axis=1)

    def subgraph_edge_count(self, mask: np.ndarray) -> int:
        """Number of edges with both endpoints inside ``mask`` (bool[|V|])."""
        src = np.repeat(np.arange(self.num_vertices, dtype=np.int64), self.degrees)
        both = mask[src] & mask[self.indices]
        return int(both.sum() // 2)

    def permute(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel vertices: new id of old vertex v is ``perm[v]``."""
        edges = self.edges_array()
        new_edges = np.stack([perm[edges[:, 0]], perm[edges[:, 1]]], axis=1)
        return CSRGraph.from_edges(new_edges, num_vertices=self.num_vertices)

    # ---------------------------------------------------------------- device
    def to(self, device: torch.device) -> DeviceCSR:
        """The graph's arrays on ``device``, copied there on first use and
        kept for the graph's lifetime. On the CPU the tensors share memory
        with the numpy arrays."""
        device = resolve_device(device)  # "cuda" and "cuda:0" share one copy
        key = str(device)
        dev = self._on_device.get(key)
        if dev is None:
            indptr = torch.from_numpy(np.ascontiguousarray(self.indptr, np.int64))
            indices = torch.from_numpy(np.ascontiguousarray(self.indices, np.int32))
            dev = DeviceCSR(indptr.to(device), indices.to(device))
            self._on_device[key] = dev
        return dev

    # ------------------------------------------------------------ construction
    @staticmethod
    def from_edges(
        edges: np.ndarray, num_vertices: int | None = None, dedupe: bool = True
    ) -> "CSRGraph":
        """Build a symmetric CSR graph from an (m, 2) int array of edges.

        Self-loops are dropped; duplicate edges (in either direction) are
        deduplicated when ``dedupe`` is set. Byte-identical to the
        reference's construction.
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        edges = edges[edges[:, 0] != edges[:, 1]]  # no self loops
        if num_vertices is None:
            num_vertices = int(edges.max()) + 1 if edges.size else 0
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        if dedupe and edges.size:
            key = lo * np.int64(num_vertices) + hi
            _, first = np.unique(key, return_index=True)
            lo, hi = lo[first], hi[first]
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        indptr = np.zeros(num_vertices + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        # vectorised per-row neighbour sort: lexsort by (src, dst)
        order2 = np.lexsort((dst, src))
        indices = dst[order2].astype(np.int32)
        return CSRGraph(indptr=indptr, indices=indices)

    # ------------------------------------------------------------- files
    def save(self, path: str) -> None:
        """An ``.npz`` dump, the reference's format."""
        np.savez_compressed(path, indptr=self.indptr, indices=self.indices)

    @staticmethod
    def load(path: str) -> "CSRGraph":
        data = np.load(path)
        return CSRGraph(indptr=data["indptr"], indices=data["indices"])

    def __repr__(self) -> str:  # pragma: no cover
        return f"CSRGraph(|V|={self.num_vertices}, |E|={self.num_edges})"
