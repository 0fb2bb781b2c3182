"""Out-of-core graph substrate: partition from disk without materializing CSR
(port of ``repro.graph.external``; files written by either package load in
the other, and the writers and the converter give the reference's bytes).

The paper's premise is that "graphs that require distributed settings are
often too large to fit in the main memory of a single machine" (§I), yet a
fully resident :class:`~repro_torch.graph.csr.CSRGraph` needs ``8(|V|+1) + 8|E|``
bytes before the first vertex streams. This module closes that gap with a
binary on-disk CSR format plus two consumers:

* :func:`convert_edge_list` - a bounded-memory two-pass converter that turns
  a text (SNAP-style ``.txt``/``.csv``) or binary (``.npy``) edge list into
  the on-disk format. Pass 1 canonicalizes edges in chunks (drop self-loops,
  ``(lo, hi)`` ordering), sorts each chunk and spills it as a run; the
  chunk sort/dedupe work runs on a :class:`~repro_torch.core.executor.ShardPool`
  so conversion scales with cores, and a vectorised k-way run merge dedupes
  globally while counting degrees. Pass 2 re-streams the deduped sorted
  edges, scatters both directions into a row-sorted adjacency, and (for the
  default version-2 output) block-compresses the rows in parallel. Peak host
  memory is ``O(|V|)`` plus a bounded number of in-flight chunks - the edge
  set is never resident. Rows come out sorted by neighbour id, so the
  decoded result is *byte-identical* to ``CSRGraph.from_edges`` on the same
  input.
* :class:`ExternalCSRGraph` - memory-maps the file and exposes the same
  ``num_vertices`` / ``neighbors`` / ``degrees`` surface ``CSRGraph`` does,
  so ``vertex_stream``, ``ShardedStream.superstep_batches`` and the chunked
  ``StreamEngine`` loops consume it unchanged. Version-1 files map the raw
  int32 ``indices`` region directly; version-2 files expose
  :class:`_CompressedIndices`, a lazy array proxy that decodes exactly the
  rows an access touches (one vectorised codec call per batch) and yields
  the same int32 values position for position.

File layout (little-endian); v1 stores raw neighbours, v2 delta-varint
blocks (see :mod:`repro_torch.graph.compress`)::

    [ 0:8 ]   magic  b"XCSRGRPH"
    [ 8:12]   uint32 format version (1 or 2)
    [12:16]   uint32 flags (v2: bit 0 = 64-bit byte offsets)
    [16:24]   int64  num_vertices                  (n)
    [24:32]   int64  len(indices) == 2|E|          (h)
    [32:40]   int64  v2: compressed data bytes     (d)   (v1: 0)
    [40:44]   uint32 v2: block capacity                  (v1: 0)
    [44:64]   reserved (zeros)
    [64:64+8(n+1)]          indptr   int64[n+1]
    v1: [.. +4h]            indices  int32[h]
    v2: [.. +4(n+1) or 8(n+1)]  byte_off uint32[n+1] (int64 when bit 0 set)
        [.. +d]             data     uint8[d]  (delta-varint blocks)

:func:`load_graph_source` resolves the ``PartitionSpec.source`` grammar
(``rmat:*`` / ``dataset:*`` / a path) into a graph object;
:func:`validate_source` is its construction-time syntax check.
"""
from __future__ import annotations

import itertools
import os
import struct
import tempfile
import threading
import time
import warnings
from collections import deque
from typing import Iterator

import numpy as np

from repro_torch.graph.compress import (
    DEFAULT_BLOCK_CAP,
    decode_adjacency,
    encode_adjacency,
)
from repro_torch.graph.csr import CSRGraph

__all__ = [
    "MAGIC",
    "FORMAT_VERSION",
    "FORMAT_VERSION_V2",
    "SUPPORTED_VERSIONS",
    "HEADER_BYTES",
    "DEFAULT_BLOCK_CAP",
    "ExternalCSRGraph",
    "SCAN_ROWS",
    "is_mapped",
    "iter_row_ranges",
    "write_external_csr",
    "convert_edge_list",
    "convert_csr",
    "raw_file_bytes",
    "load_graph_file",
    "load_graph_source",
    "validate_source",
]

MAGIC = b"XCSRGRPH"
FORMAT_VERSION = 1  # raw int32 neighbours
FORMAT_VERSION_V2 = 2  # delta-varint neighbour blocks + byte-offset index
SUPPORTED_VERSIONS = (1, 2)
HEADER_BYTES = 64
_HEADER_STRUCT = "<8sII qq q I"
_FLAG_WIDE_OFFSETS = 1  # v2: byte_off stored as int64 (data region >= 4 GiB)
# the largest data region a v2 file indexes with uint32 byte offsets
_MAX_NARROW_OFFSET = 0xFFFFFFFF
_INDPTR_DTYPE = np.dtype("<i8")
_INDICES_DTYPE = np.dtype("<i4")
_OFF32_DTYPE = np.dtype("<u4")
_OFF64_DTYPE = np.dtype("<i8")
# keys pack (lo, hi) into one int64: ids must fit the int32 indices anyway
_MAX_VERTEX_ID = np.int64(2**31 - 1)
# target decoded values per codec call when chunking whole-graph scans
_DECODE_CHUNK_VALUES = 1 << 21


def _pack_header(
    num_vertices: int,
    half_edges: int,
    *,
    version: int = FORMAT_VERSION,
    flags: int = 0,
    data_bytes: int = 0,
    block_cap: int = 0,
) -> bytes:
    head = struct.pack(
        _HEADER_STRUCT, MAGIC, int(version), int(flags), int(num_vertices),
        int(half_edges), int(data_bytes), int(block_cap),
    )
    return head + b"\0" * (HEADER_BYTES - len(head))


def _file_layout(num_vertices: int, half_edges: int) -> tuple[int, int, int]:
    """v1 layout: (indptr_offset, indices_offset, total_file_bytes)."""
    indptr_off = HEADER_BYTES
    indices_off = indptr_off + _INDPTR_DTYPE.itemsize * (num_vertices + 1)
    total = indices_off + _INDICES_DTYPE.itemsize * half_edges
    return indptr_off, indices_off, total


def _file_layout_v2(
    num_vertices: int, data_bytes: int, wide: bool
) -> tuple[int, int, int, int]:
    """v2 layout: (indptr_off, byte_off_off, data_off, total_file_bytes)."""
    indptr_off = HEADER_BYTES
    byte_off_off = indptr_off + _INDPTR_DTYPE.itemsize * (num_vertices + 1)
    itemsize = _OFF64_DTYPE.itemsize if wide else _OFF32_DTYPE.itemsize
    data_off = byte_off_off + itemsize * (num_vertices + 1)
    return indptr_off, byte_off_off, data_off, data_off + data_bytes


def raw_file_bytes(num_vertices: int, half_edges: int) -> int:
    """Size a v1 (raw int32) file of this shape would occupy - the
    denominator of every compression-ratio report."""
    return _file_layout(num_vertices, half_edges)[2]


# ----------------------------------------------------- compressed adjacency
class _CompressedIndices:
    """Lazy ``indices`` array proxy over a v2 compressed data region.

    Quacks like the int32[h] neighbour array (``shape`` / ``len`` /
    ``__getitem__`` with ints, slices, index arrays and masks /
    ``__array__``) but holds no decoded data: every access maps the flat
    positions it touches to adjacency rows via ``searchsorted(indptr)``,
    gathers those rows' byte extents from the mmapped block index, and runs
    **one** vectorised :func:`~repro_torch.graph.compress.decode_adjacency` call.
    Block restarts inside the codec mean a row is always decodable on its
    own - no neighbouring state needed.

    Decoded values are bounds-checked against ``num_vertices`` so a corrupt
    data region raises instead of silently mis-partitioning. Cumulative
    decode wall time / call count feed the ``decode_wall_s`` telemetry.
    """

    dtype = _INDICES_DTYPE
    ndim = 1

    def __init__(self, graph: "ExternalCSRGraph"):
        self._g = graph
        self.decode_seconds = 0.0
        self.decode_calls = 0
        self._lock = threading.Lock()

    @property
    def shape(self) -> tuple[int]:
        return (self._g._half,)

    @property
    def nbytes(self) -> int:
        """Logical (decoded) size, mirroring the raw-array surface."""
        return self._g._half * _INDICES_DTYPE.itemsize

    def __len__(self) -> int:
        return self._g._half

    # ------------------------------------------------------------- decoding
    def _checked(self, vals: np.ndarray) -> np.ndarray:
        if vals.size and (
            int(vals.min()) < 0 or int(vals.max()) >= self._g._n
        ):
            raise ValueError(
                f"{self._g.path!r}: decoded neighbour id out of range "
                f"(corrupt compressed data)"
            )
        return vals.astype(_INDICES_DTYPE)

    def _decode_range(self, r0: int, r1: int) -> np.ndarray:
        """Decode rows [r0, r1) into one flat int32 array."""
        g = self._g
        if r1 <= r0:
            return np.empty(0, dtype=_INDICES_DTYPE)
        t0 = time.perf_counter()
        b0, b1 = int(g.byte_off[r0]), int(g.byte_off[r1])
        buf = np.asarray(g.data[b0:b1])
        degs = np.asarray(g.indptr[r0 + 1 : r1 + 1]) - np.asarray(
            g.indptr[r0:r1]
        )
        off = np.asarray(g.byte_off[r0 : r1 + 1], dtype=np.int64) - b0
        vals = self._checked(
            decode_adjacency(buf, degs, g.block_cap, row_byte_off=off)
        )
        self._account(time.perf_counter() - t0)
        return vals

    def _decode_row_set(
        self, rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Decode a sorted-unique row set; returns ``(flat, value_starts)``
        where ``flat[value_starts[i] : value_starts[i] + deg(rows[i])]`` is
        row ``rows[i]``. One codec call regardless of row count."""
        g = self._g
        t0 = time.perf_counter()
        degs = np.asarray(g.indptr[rows + 1]) - np.asarray(g.indptr[rows])
        bo_lo = np.asarray(g.byte_off[rows], dtype=np.int64)
        bo_hi = np.asarray(g.byte_off[rows + 1], dtype=np.int64)
        # slice contiguous runs of rows in one go instead of per row
        breaks = np.flatnonzero(np.diff(rows) != 1) + 1
        run_lo = np.concatenate(([0], breaks))
        run_hi = np.concatenate((breaks, [rows.shape[0]]))
        bufs = [
            g.data[bo_lo[a] : bo_hi[b - 1]] for a, b in zip(run_lo, run_hi)
        ]
        buf = np.concatenate(bufs) if len(bufs) > 1 else np.asarray(bufs[0])
        row_bytes = bo_hi - bo_lo
        syn_off = np.zeros(rows.shape[0] + 1, dtype=np.int64)
        np.cumsum(row_bytes, out=syn_off[1:])
        vals = self._checked(
            decode_adjacency(buf, degs, g.block_cap, row_byte_off=syn_off)
        )
        starts = np.cumsum(degs) - degs
        self._account(time.perf_counter() - t0)
        return vals, starts

    def _account(self, dt: float) -> None:
        with self._lock:
            self.decode_seconds += dt
            self.decode_calls += 1

    # ------------------------------------------------------------- indexing
    def _row_of(self, pos: np.ndarray) -> np.ndarray:
        return np.searchsorted(self._g.indptr, pos, side="right") - 1

    def _gather(self, pos: np.ndarray) -> np.ndarray:
        g = self._g
        if pos.size == 0:
            return np.empty(0, dtype=_INDICES_DTYPE)
        lo, hi = int(pos.min()), int(pos.max())
        if lo < 0 or hi >= g._half:
            raise IndexError(
                f"index out of bounds for compressed indices of length "
                f"{g._half}"
            )
        rows = self._row_of(pos)
        rows_u, inv = np.unique(rows, return_inverse=True)
        flat, starts = self._decode_row_set(rows_u)
        row_base = np.asarray(g.indptr[rows], dtype=np.int64)
        return flat[starts[inv] + (pos - row_base)]

    def __getitem__(self, key):
        g = self._g
        if isinstance(key, (int, np.integer)):
            pos = int(key)
            if pos < 0:
                pos += g._half
            if not 0 <= pos < g._half:
                raise IndexError(
                    f"index {key} out of bounds for length {g._half}"
                )
            r = int(self._row_of(np.asarray([pos]))[0])
            row = self._decode_range(r, r + 1)
            return row[pos - int(g.indptr[r])]
        if isinstance(key, slice):
            start, stop, step = key.indices(g._half)
            if step != 1:
                return self._gather(
                    np.arange(start, stop, step, dtype=np.int64)
                )
            if stop <= start:
                return np.empty(0, dtype=_INDICES_DTYPE)
            r0 = int(np.searchsorted(g.indptr, start, side="right")) - 1
            r1 = max(
                int(np.searchsorted(g.indptr, stop, side="left")), r0 + 1
            )
            flat = self._decode_range(r0, r1)
            base = int(g.indptr[r0])
            return flat[start - base : stop - base]
        key = np.asarray(key)
        if key.dtype == bool:
            key = np.flatnonzero(key)
        return self._gather(key.astype(np.int64, copy=False))

    # --------------------------------------------------------- materializing
    def __array__(self, dtype=None, copy=None):
        g = self._g
        out = np.empty(g._half, dtype=_INDICES_DTYPE)
        r0 = 0
        while r0 < g._n:
            r1 = max(
                int(
                    np.searchsorted(
                        g.indptr, int(g.indptr[r0]) + _DECODE_CHUNK_VALUES
                    )
                ),
                r0 + 1,
            )
            r1 = min(r1, g._n)
            out[int(g.indptr[r0]) : int(g.indptr[r1])] = self._decode_range(
                r0, r1
            )
            r0 = r1
        return out if dtype is None else out.astype(dtype, copy=False)

    def astype(self, dtype, copy: bool = True):
        return np.asarray(self).astype(dtype, copy=False)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"_CompressedIndices(h={self._g._half}, "
            f"data_bytes={self._g._data_bytes})"
        )


# ---------------------------------------------------------------- the graph
class ExternalCSRGraph:
    """A CSR graph memory-mapped from the on-disk binary format.

    Exposes the ``CSRGraph`` read surface (``indptr`` / ``indices`` /
    ``num_vertices`` / ``num_edges`` / ``degrees`` / ``neighbors`` /
    ``degree`` / ``iter_adjacency``) over ``np.memmap`` arrays, so every
    partitioner, stream order, and engine chunk loop works unchanged - a
    chunk's neighbour batch is a fancy-indexed *copy* of the mapped pages it
    touches, never the whole graph. Version-2 files interpose
    :class:`_CompressedIndices`, which decodes exactly the rows an access
    needs; decoded values are identical to the v1/resident arrays, so
    assignments stay bit-identical. Only ``O(|V|)`` bookkeeping is ever
    resident.

    Unlike :class:`~repro_torch.graph.csr.CSRGraph` it has no ``to(device)``:
    the card never holds the whole graph. The engine copies each chunk's or
    superstep's decoded rows to the card (the partition-score kernel's rows
    entries), and the quality and sub-partition scans copy one row range at
    a time (:func:`iter_row_ranges`).
    """

    backing = "mapped"

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        try:
            size = os.path.getsize(self.path)
        except OSError as e:
            raise ValueError(f"cannot open external graph {self.path!r}: {e}") from e
        if size < HEADER_BYTES:
            raise ValueError(
                f"{self.path!r} is not an external CSR graph: file is "
                f"{size} bytes, smaller than the {HEADER_BYTES}-byte header"
            )
        with open(self.path, "rb") as f:
            head = f.read(HEADER_BYTES)
        magic, version, flags, n, h, data_bytes, block_cap = struct.unpack(
            _HEADER_STRUCT, head[: struct.calcsize(_HEADER_STRUCT)]
        )
        if magic != MAGIC:
            raise ValueError(
                f"{self.path!r} is not an external CSR graph "
                f"(bad magic {magic!r}; expected {MAGIC!r})"
            )
        if version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"{self.path!r}: unsupported format version {version} "
                f"(this build reads versions "
                f"{', '.join(map(str, SUPPORTED_VERSIONS))})"
            )
        if n < 0 or h < 0 or h % 2:
            raise ValueError(
                f"{self.path!r}: corrupt header (num_vertices={n}, "
                f"len(indices)={h})"
            )
        self._n = int(n)
        self._half = int(h)
        self.format_version = int(version)
        self.block_cap = int(block_cap)
        self._data_bytes = int(data_bytes)
        if version == FORMAT_VERSION:
            indptr_off, indices_off, expected = _file_layout(n, h)
            if size != expected:
                raise ValueError(
                    f"{self.path!r}: truncated or corrupt - file is {size} "
                    f"bytes but the header declares {expected} "
                    f"(num_vertices={n}, len(indices)={h})"
                )
            self._total_bytes = expected
            self.indptr = np.memmap(
                self.path, dtype=_INDPTR_DTYPE, mode="r", offset=indptr_off,
                shape=(self._n + 1,),
            )
            self.byte_off = None
            self.data = None
            self.indices = np.memmap(
                self.path, dtype=_INDICES_DTYPE, mode="r", offset=indices_off,
                shape=(self._half,),
            )
        else:
            if data_bytes < 0 or block_cap < 1:
                raise ValueError(
                    f"{self.path!r}: corrupt v2 header (data_bytes="
                    f"{data_bytes}, block_cap={block_cap})"
                )
            wide = bool(flags & _FLAG_WIDE_OFFSETS)
            indptr_off, byte_off_off, data_off, expected = _file_layout_v2(
                n, data_bytes, wide
            )
            if size != expected:
                raise ValueError(
                    f"{self.path!r}: truncated or corrupt - file is {size} "
                    f"bytes but the header declares {expected} "
                    f"(num_vertices={n}, data_bytes={data_bytes})"
                )
            self._total_bytes = expected
            self.indptr = np.memmap(
                self.path, dtype=_INDPTR_DTYPE, mode="r", offset=indptr_off,
                shape=(self._n + 1,),
            )
            self.byte_off = np.memmap(
                self.path,
                dtype=_OFF64_DTYPE if wide else _OFF32_DTYPE,
                mode="r",
                offset=byte_off_off,
                shape=(self._n + 1,),
            )
            self.data = np.memmap(
                self.path, dtype=np.uint8, mode="r", offset=data_off,
                shape=(self._data_bytes,),
            )
            if self._n and (
                int(self.byte_off[0]) != 0
                or int(self.byte_off[-1]) != self._data_bytes
            ):
                raise ValueError(
                    f"{self.path!r}: corrupt block index (byte_off[0]="
                    f"{int(self.byte_off[0])}, byte_off[-1]="
                    f"{int(self.byte_off[-1])}, data_bytes={self._data_bytes})"
                )
            self.indices = _CompressedIndices(self)
        if self._n and (
            int(self.indptr[0]) != 0 or int(self.indptr[-1]) != self._half
        ):
            raise ValueError(
                f"{self.path!r}: corrupt indptr (indptr[0]={int(self.indptr[0])}, "
                f"indptr[-1]={int(self.indptr[-1])}, len(indices)={self._half})"
            )
        self._degrees: np.ndarray | None = None

    # ----------------------------------------------------- CSRGraph surface
    @property
    def num_vertices(self) -> int:
        return self._n

    @property
    def num_edges(self) -> int:
        return self._half // 2

    @property
    def degrees(self) -> np.ndarray:
        # cached: the engines ask repeatedly and a diff over the mapped
        # indptr is the only O(|V|) array this graph ever materializes
        if self._degrees is None:
            self._degrees = np.diff(self.indptr)
        return self._degrees

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def iter_adjacency(self, order=None) -> Iterator[tuple[int, np.ndarray]]:
        ids = range(self._n) if order is None else order
        for v in ids:
            yield int(v), self.neighbors(int(v))

    def edges_array(self) -> np.ndarray:
        """(|E|, 2) array with each undirected edge listed once (u < v).

        Same contract as ``CSRGraph.edges_array`` - the vertex-cut edge
        partitioners (hdrf/ginger) consume it. Note the *result* is O(|E|)
        resident by definition; the scan over the mapped file is chunked so
        no symmetric 2|E| intermediate is ever materialized.
        """
        out = np.empty((self.num_edges, 2), dtype=np.int64)
        filled = 0
        chunk = 1 << 20
        indptr = self.indptr
        for lo in range(0, self._n, chunk):
            hi = min(lo + chunk, self._n)
            degs = np.asarray(indptr[lo + 1 : hi + 1]) - np.asarray(indptr[lo:hi])
            src = np.repeat(np.arange(lo, hi, dtype=np.int64), degs)
            dst = np.asarray(
                self.indices[indptr[lo] : indptr[hi]], dtype=np.int64
            )
            mask = src < dst
            m = int(mask.sum())
            out[filled : filled + m, 0] = src[mask]
            out[filled : filled + m, 1] = dst[mask]
            filled += m
        assert filled == out.shape[0]
        return out

    def subgraph_edge_count(self, mask: np.ndarray) -> int:
        """Edges with both endpoints inside ``mask`` (bool[|V|]), chunked
        over the mapped adjacency like ``CSRGraph.subgraph_edge_count``."""
        total = 0
        chunk = 1 << 20
        indptr = self.indptr
        for lo in range(0, self._n, chunk):
            hi = min(lo + chunk, self._n)
            degs = np.asarray(indptr[lo + 1 : hi + 1]) - np.asarray(indptr[lo:hi])
            src = np.repeat(np.arange(lo, hi, dtype=np.int64), degs)
            dst = np.asarray(self.indices[indptr[lo] : indptr[hi]])
            total += int((mask[src] & mask[dst]).sum())
        return total // 2

    # --------------------------------------------------------------- memory
    @property
    def nbytes_mapped(self) -> int:
        """Bytes of graph data reachable through the mapping (the file)."""
        return self._total_bytes

    @property
    def nbytes_resident(self) -> int:
        """Bytes of graph data held in ordinary host arrays (the degree
        cache, once computed) - what an OOM accountant should charge."""
        return 0 if self._degrees is None else int(self._degrees.nbytes)

    @property
    def nbytes_compressed(self) -> int:
        """Bytes of the compressed adjacency representation (block index +
        varint data) for v2 files; 0 for raw v1 files."""
        if self.format_version != FORMAT_VERSION_V2:
            return 0
        return int(self.byte_off.nbytes) + self._data_bytes

    @property
    def decode_wall_s(self) -> float:
        """Cumulative adjacency-decode wall time (0.0 for raw v1 files)."""
        return float(getattr(self.indices, "decode_seconds", 0.0))

    # -------------------------------------------------------------- escape
    def to_csr(self) -> CSRGraph:
        """Materialize a fully resident ``CSRGraph`` (for small graphs)."""
        return CSRGraph(
            indptr=np.asarray(self.indptr).copy(),
            indices=np.asarray(self.indices).copy(),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ExternalCSRGraph(|V|={self.num_vertices}, |E|={self.num_edges}, "
            f"v{self.format_version}, path={self.path!r})"
        )


def is_mapped(graph) -> bool:
    """Whether ``graph`` is memory-mapped (``backing == "mapped"``); such a
    graph is never copied to a device whole."""
    return getattr(graph, "backing", "resident") == "mapped"


# rows a range scan of a mapped graph decodes and uploads at a time, the
# reference's ``edges_array`` / ``subgraph_edge_count`` chunk
SCAN_ROWS = 1 << 20


def iter_row_ranges(graph):
    """Yield ``(lo, degs, dst)`` for consecutive row ranges ``[lo, lo +
    len(degs))`` of at most :data:`SCAN_ROWS` rows: the rows' int64 degrees
    (from the graph's degree cache, which the reference's scans also fill)
    and their neighbour ids (int32, a fresh host array), decoded once a
    range. The range scans of ``quality_report`` and
    ``build_subpartition_graph`` over a mapped graph."""
    indptr, degrees = graph.indptr, graph.degrees
    n = graph.num_vertices
    for lo in range(0, n, SCAN_ROWS):
        hi = min(lo + SCAN_ROWS, n)
        dst = np.array(graph.indices[int(indptr[lo]) : int(indptr[hi])], dtype=_INDICES_DTYPE)
        yield lo, np.ascontiguousarray(degrees[lo:hi], dtype=np.int64), dst


# ----------------------------------------------------------------- writers
def _iter_row_chunks(
    indptr: np.ndarray, target_values: int = _DECODE_CHUNK_VALUES
) -> Iterator[tuple[int, int]]:
    """Split rows into ``(r0, r1)`` ranges of ~``target_values`` adjacency
    entries each (always whole rows, always >= 1 row of progress)."""
    n = int(indptr.shape[0]) - 1
    r0 = 0
    while r0 < n:
        r1 = int(np.searchsorted(indptr, int(indptr[r0]) + target_values))
        r1 = min(max(r1, r0 + 1), n)
        yield r0, r1
        r0 = r1


def write_external_csr(
    path: str | os.PathLike,
    indptr: np.ndarray,
    indices: np.ndarray,
    *,
    version: int = FORMAT_VERSION,
    block_cap: int = DEFAULT_BLOCK_CAP,
) -> None:
    """Write CSR arrays in the on-disk format.

    ``version=1`` (default) writes the raw int32 layout; ``version=2``
    delta-varint compresses the rows (requires each row sorted strictly
    ascending, the ``CSRGraph.from_edges`` invariant).
    """
    indptr = np.ascontiguousarray(indptr, dtype=_INDPTR_DTYPE)
    indices = np.ascontiguousarray(indices, dtype=_INDICES_DTYPE)
    n = int(indptr.shape[0]) - 1
    if n < 0:
        raise ValueError("indptr must have at least one entry")
    if version == FORMAT_VERSION:
        with open(path, "wb") as f:
            f.write(_pack_header(n, int(indices.shape[0])))
            indptr.tofile(f)
            indices.tofile(f)
        return
    if version != FORMAT_VERSION_V2:
        raise ValueError(
            f"unsupported format version {version} (can write "
            f"{', '.join(map(str, SUPPORTED_VERSIONS))})"
        )
    pieces: list[np.ndarray] = []
    row_bytes = np.zeros(max(n, 1), dtype=np.int64)[:n]
    for r0, r1 in _iter_row_chunks(indptr):
        flat = np.asarray(
            indices[int(indptr[r0]) : int(indptr[r1])], dtype=np.int64
        )
        degs = indptr[r0 + 1 : r1 + 1] - indptr[r0:r1]
        data, rb = encode_adjacency(flat, degs, block_cap)
        pieces.append(data)
        row_bytes[r0:r1] = rb
    data_bytes = int(row_bytes.sum())
    wide = data_bytes > _MAX_NARROW_OFFSET
    byte_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_bytes, out=byte_off[1:])
    with open(path, "wb") as f:
        f.write(
            _pack_header(
                n,
                int(indices.shape[0]),
                version=FORMAT_VERSION_V2,
                flags=_FLAG_WIDE_OFFSETS if wide else 0,
                data_bytes=data_bytes,
                block_cap=block_cap,
            )
        )
        indptr.tofile(f)
        byte_off.astype(_OFF64_DTYPE if wide else _OFF32_DTYPE).tofile(f)
        for piece in pieces:
            piece.tofile(f)


def convert_csr(
    graph: CSRGraph,
    path: str | os.PathLike,
    *,
    format_version: int = FORMAT_VERSION_V2,
    block_cap: int = DEFAULT_BLOCK_CAP,
) -> None:
    """Dump an in-memory ``CSRGraph`` into the on-disk format (compressed
    v2 by default)."""
    write_external_csr(
        path, graph.indptr, graph.indices,
        version=format_version, block_cap=block_cap,
    )


# --------------------------------------------------------------- converter
def _iter_edge_chunks(
    path: str, chunk_edges: int, delimiter: str | None
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield ``(src, dst)`` int64 chunks from a text or ``.npy`` edge list.

    Text: ``#``-comment lines skipped, first two whitespace- (or
    ``delimiter``-) separated columns used, extra columns (weights,
    timestamps) ignored. ``.npy``: the array is memory-mapped and sliced.
    """
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        if arr.ndim != 2 or arr.shape[1] < 2:
            raise ValueError(
                f"{path!r}: expected an (m, >=2) edge array, got shape "
                f"{arr.shape}"
            )
        for lo in range(0, arr.shape[0], chunk_edges):
            block = np.asarray(arr[lo : lo + chunk_edges, :2], dtype=np.int64)
            yield block[:, 0], block[:, 1]
        return
    if delimiter is None and path.endswith(".csv"):
        delimiter = ","
    with open(path, "rt") as f:
        while True:
            lines = list(itertools.islice(f, chunk_edges))
            if not lines:
                return
            with warnings.catch_warnings():
                # a chunk of only comment/blank lines (SNAP headers) is fine
                warnings.filterwarnings(
                    "ignore", message=".*input contained no data.*"
                )
                block = np.loadtxt(
                    lines, dtype=np.int64, comments="#", delimiter=delimiter,
                    usecols=(0, 1), ndmin=2,
                )
            if block.size:
                yield block[:, 0], block[:, 1]


def _merge_sorted_runs(
    runs: list[np.ndarray], block: int
) -> Iterator[np.ndarray]:
    """Globally sorted, deduplicated int64 blocks from sorted-unique runs.

    Vectorised k-way merge: refill a bounded buffer per run, emit everything
    up to the smallest "safe boundary" (the last loaded key of any run that
    still has unread data - every unread key of such a run is greater), and
    carry the remainder. Memory is ``O(len(runs) * block)``.
    """
    pos = [0] * len(runs)
    bufs: list[np.ndarray] = [np.empty(0, dtype=np.int64) for _ in runs]
    while True:
        for i, run in enumerate(runs):
            if bufs[i].size == 0 and pos[i] < run.shape[0]:
                take = min(block, run.shape[0] - pos[i])
                bufs[i] = np.asarray(run[pos[i] : pos[i] + take], dtype=np.int64)
                pos[i] += take
        active = [i for i in range(len(runs)) if bufs[i].size]
        if not active:
            return
        unread = [i for i in active if pos[i] < runs[i].shape[0]]
        if unread:
            bound = min(int(bufs[i][-1]) for i in unread)
        else:
            bound = max(int(bufs[i][-1]) for i in active)
        parts = []
        for i in active:
            cut = int(np.searchsorted(bufs[i], bound, side="right"))
            if cut:
                parts.append(bufs[i][:cut])
                bufs[i] = bufs[i][cut:]
        merged = parts[0] if len(parts) == 1 else np.concatenate(parts)
        out = np.unique(merged)  # runs are unique; cross-run dupes collapse here
        if out.size:
            yield out


def _spill_run(
    s: np.ndarray, d: np.ndarray, run_path: str, src_path: str
) -> tuple[int, int]:
    """Canonicalize + sort + dedupe one edge chunk and spill it as a run.

    Pure function of its chunk (runs on pool workers): drops self-loops,
    validates the id range, packs ``(lo, hi)`` keys, writes the sorted
    unique keys to ``run_path``. Returns ``(keys_written, max_id)``.
    """
    keep = s != d  # no self loops
    s, d = s[keep], d[keep]
    if s.size == 0:
        return 0, -1
    cmin = min(int(s.min()), int(d.min()))
    cmax = max(int(s.max()), int(d.max()))
    if cmin < 0:
        raise ValueError(
            f"{src_path!r}: negative vertex id {cmin} in edge list"
        )
    if cmax > int(_MAX_VERTEX_ID):
        raise ValueError(
            f"{src_path!r}: vertex id {cmax} exceeds the int32 "
            f"index range of the on-disk format"
        )
    lo = np.minimum(s, d)
    hi = np.maximum(s, d)
    key = np.unique((lo << np.int64(32)) | hi)
    key.tofile(run_path)
    return int(key.shape[0]), cmax


def _encode_row_range(
    raw: np.ndarray, indptr: np.ndarray, r0: int, r1: int, block_cap: int
) -> tuple[np.ndarray, np.ndarray]:
    """Compress rows [r0, r1) of the scattered raw adjacency (pool task)."""
    flat = np.asarray(raw[int(indptr[r0]) : int(indptr[r1])], dtype=np.int64)
    return encode_adjacency(flat, indptr[r0 + 1 : r1 + 1] - indptr[r0:r1],
                            block_cap)


def convert_edge_list(
    src_path: str | os.PathLike,
    out_path: str | os.PathLike,
    *,
    num_vertices: int | None = None,
    chunk_edges: int = 1 << 22,
    merge_block: int = 1 << 20,
    delimiter: str | None = None,
    tmp_dir: str | None = None,
    format_version: int = FORMAT_VERSION_V2,
    block_cap: int = DEFAULT_BLOCK_CAP,
    max_workers: int = 0,
) -> dict:
    """Two-pass, bounded-memory edge-list -> on-disk CSR conversion.

    Semantics match ``CSRGraph.from_edges(edges, num_vertices)`` exactly:
    self-loops dropped, duplicate edges (either direction) deduplicated,
    symmetric storage, each adjacency row sorted ascending - so
    ``ExternalCSRGraph(out_path)`` decodes bit-identical to the in-memory
    build. The per-chunk sort/dedupe of pass 1 and the per-row-range block
    compression of pass 2 run on a ``ShardPool`` (``max_workers=0`` = one
    per core, ``1`` = fully sequential); a bounded in-flight window keeps
    memory at O(workers * chunk). All scratch files live in a temporary
    directory that is removed even when conversion fails, and a partially
    written ``out_path`` is unlinked on error.

    Returns a stats dict (``num_vertices``, ``num_edges``, ``input_edges``,
    ``runs``, ``file_bytes``, ``raw_bytes``, ``compression_ratio``,
    ``format_version``, ``workers``).
    """
    from repro_torch.core.executor import ShardPool

    src_path = os.fspath(src_path)
    out_path = os.fspath(out_path)
    chunk_edges = max(int(chunk_edges), 1)
    merge_block = max(int(merge_block), 1)
    if format_version not in SUPPORTED_VERSIONS:
        raise ValueError(
            f"unsupported format version {format_version} (can write "
            f"{', '.join(map(str, SUPPORTED_VERSIONS))})"
        )
    pool = ShardPool(max_workers, 1 << 16)
    window = pool.workers + 2  # bounded in-flight chunks
    wrote_out = False
    try:
        with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
            # ---- pass 1a: canonicalize chunks, spill sorted-unique runs
            # (chunk reads stay sequential - the file is one stream - but
            # sort/dedupe/spill overlap across the in-flight window)
            input_edges = 0
            max_id = -1
            run_files: list[str] = []
            pending: deque = deque()  # (future, run_path) in chunk order

            def _harvest() -> None:
                nonlocal max_id
                fut, run_path = pending.popleft()
                written, cmax = fut.result()
                max_id = max(max_id, cmax)
                if written:
                    run_files.append(run_path)

            try:
                for ci, (s, d) in enumerate(
                    _iter_edge_chunks(src_path, chunk_edges, delimiter)
                ):
                    input_edges += int(s.shape[0])
                    run = os.path.join(td, f"run{ci}.i64")
                    pending.append(
                        (pool.submit(_spill_run, s, d, run, src_path), run)
                    )
                    if len(pending) >= window:
                        _harvest()
                while pending:
                    _harvest()
            finally:
                # a failed chunk must not leave workers writing into td
                # while TemporaryDirectory tears it down
                while pending:
                    try:
                        pending.popleft()[0].result()
                    except BaseException:
                        pass

            if num_vertices is None:
                n = max_id + 1
            else:
                n = int(num_vertices)
                if max_id >= n:
                    raise ValueError(
                        f"{src_path!r}: vertex id {max_id} >= num_vertices={n}"
                    )
            num_runs = len(run_files)

            # ---- pass 1b: merge runs -> deduped sorted edge file + degrees
            runs = [np.memmap(r, dtype=np.int64, mode="r") for r in run_files]
            degrees = np.zeros(n, dtype=np.int64)
            dedup_path = os.path.join(td, "edges.sorted.i64")
            unique_edges = 0
            try:
                with open(dedup_path, "wb") as f:
                    for block in _merge_sorted_runs(runs, merge_block):
                        lo = (block >> np.int64(32)).astype(np.int64)
                        hi = (block & np.int64(0xFFFFFFFF)).astype(np.int64)
                        degrees += np.bincount(lo, minlength=n)
                        degrees += np.bincount(hi, minlength=n)
                        block.tofile(f)
                        unique_edges += int(block.shape[0])
            finally:
                del runs  # release run memmaps before td teardown
            half = 2 * unique_edges

            # ---- pass 2: scatter both edge directions into a row-sorted
            # adjacency; v1 writes it straight into out_path, v2 scatters
            # into scratch and block-compresses the rows in parallel
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(degrees, out=indptr[1:])
            if format_version == FORMAT_VERSION:
                indptr_off, indices_off, total = _file_layout(n, half)
                wrote_out = True
                with open(out_path, "wb") as f:
                    f.write(_pack_header(n, half))
                    indptr.astype(_INDPTR_DTYPE).tofile(f)
                    f.truncate(total)
                _scatter_adjacency(
                    out_path, indices_off, dedup_path, indptr,
                    unique_edges, merge_block,
                )
                data_bytes = 0
            else:
                raw_path = os.path.join(td, "raw.i32")
                with open(raw_path, "wb") as f:
                    f.truncate(max(_INDICES_DTYPE.itemsize * half, 1))
                _scatter_adjacency(
                    raw_path, 0, dedup_path, indptr, unique_edges, merge_block
                )
                # flag before the call: a failure during final assembly must
                # still unlink the partially written out_path
                wrote_out = True
                total, data_bytes = _compress_scattered(
                    raw_path, out_path, indptr, half, block_cap, pool, window,
                )
    except BaseException:
        if wrote_out and os.path.exists(out_path):
            try:
                os.unlink(out_path)  # no partial graph files left behind
            except OSError:
                pass
        raise
    finally:
        pool.shutdown()
    raw_bytes = _file_layout(n, half)[2]
    return {
        "num_vertices": int(n),
        "num_edges": int(unique_edges),
        "input_edges": int(input_edges),
        "runs": num_runs,
        "file_bytes": int(total),
        "raw_bytes": int(raw_bytes),
        "data_bytes": int(data_bytes),
        "compression_ratio": round(raw_bytes / total, 4) if total else 0.0,
        "format_version": int(format_version),
        "workers": pool.workers,
    }


def _scatter_adjacency(
    path: str,
    offset: int,
    dedup_path: str,
    indptr: np.ndarray,
    unique_edges: int,
    merge_block: int,
) -> None:
    """Scatter both directions of the deduped sorted edge stream into the
    int32 adjacency region at ``path[offset:]``, each row ascending."""
    n = indptr.shape[0] - 1
    half = 2 * unique_edges
    cursor = indptr[:-1].copy()
    if half:
        indices = np.memmap(
            path, dtype=_INDICES_DTYPE, mode="r+", offset=offset,
            shape=(half,),
        )
        dedup = np.memmap(dedup_path, dtype=np.int64, mode="r")
        try:
            for blo in range(0, unique_edges, merge_block):
                block = np.asarray(dedup[blo : blo + merge_block])
                lo = (block >> np.int64(32)).astype(np.int64)
                hi = (block & np.int64(0xFFFFFFFF)).astype(np.int64)
                # within a key-sorted block, every (u, v) contribution to a
                # row v (u < v) precedes every (v, w) contribution (the key
                # (u, v) sorts before (v, w)), so writing the hi side first,
                # then the lo side, fills each row ascending - the exact
                # per-row order CSRGraph.from_edges produces
                order = np.argsort(hi, kind="stable")
                indices[_grouped_positions(cursor, hi[order])] = lo[
                    order
                ].astype(_INDICES_DTYPE)
                indices[_grouped_positions(cursor, lo)] = hi.astype(
                    _INDICES_DTYPE
                )
            indices.flush()
        finally:
            del indices, dedup
    if not np.array_equal(cursor, indptr[1:]):
        raise AssertionError(
            "internal error: adjacency rows not completely filled"
        )


def _compress_scattered(
    raw_path: str,
    out_path: str,
    indptr: np.ndarray,
    half: int,
    block_cap: int,
    pool,
    window: int,
) -> tuple[int, int]:
    """Block-compress the scattered raw adjacency into a v2 ``out_path``.

    Row ranges are encoded on pool workers (results consumed in order, a
    bounded window in flight) and streamed to a scratch data file; the final
    file is assembled once ``data_bytes`` - and with it the byte-offset
    dtype - is known. Returns ``(total_file_bytes, data_bytes)``.
    """
    n = indptr.shape[0] - 1
    raw = np.memmap(raw_path, dtype=_INDICES_DTYPE, mode="r", shape=(half,))
    row_bytes = np.zeros(n, dtype=np.int64)
    data_path = raw_path + ".data"
    try:
        with open(data_path, "wb") as df:
            pending: deque = deque()  # (future, r0, r1) in row order

            def _drain() -> None:
                fut, r0, r1 = pending.popleft()
                data, rb = fut.result()
                row_bytes[r0:r1] = rb
                data.tofile(df)

            try:
                for r0, r1 in _iter_row_chunks(indptr):
                    pending.append(
                        (
                            pool.submit(
                                _encode_row_range, raw, indptr, r0, r1,
                                block_cap,
                            ),
                            r0,
                            r1,
                        )
                    )
                    if len(pending) >= window:
                        _drain()
                while pending:
                    _drain()
            finally:
                while pending:
                    try:
                        pending.popleft()[0].result()
                    except BaseException:
                        pass
    finally:
        del raw
    data_bytes = int(row_bytes.sum())
    wide = data_bytes > _MAX_NARROW_OFFSET
    byte_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_bytes, out=byte_off[1:])
    total = _file_layout_v2(n, data_bytes, wide)[3]
    with open(out_path, "wb") as f:
        f.write(
            _pack_header(
                n, half,
                version=FORMAT_VERSION_V2,
                flags=_FLAG_WIDE_OFFSETS if wide else 0,
                data_bytes=data_bytes,
                block_cap=block_cap,
            )
        )
        indptr.astype(_INDPTR_DTYPE).tofile(f)
        byte_off.astype(_OFF64_DTYPE if wide else _OFF32_DTYPE).tofile(f)
        with open(data_path, "rb") as df:
            while True:
                piece = df.read(1 << 24)
                if not piece:
                    break
                f.write(piece)
    return total, data_bytes


def _grouped_positions(cursor: np.ndarray, grp: np.ndarray) -> np.ndarray:
    """Write positions ``cursor[grp] + rank-within-group`` for a *sorted*
    group-id array, advancing ``cursor`` by each group's count."""
    m = grp.shape[0]
    if m == 0:
        return np.empty(0, dtype=np.int64)
    seg_starts = np.concatenate(([0], np.flatnonzero(np.diff(grp)) + 1))
    counts = np.diff(np.concatenate((seg_starts, [m])))
    offsets = np.arange(m, dtype=np.int64) - np.repeat(seg_starts, counts)
    pos = cursor[grp] + offsets
    cursor[grp[seg_starts]] += counts
    return pos


# ------------------------------------------------------------ spec sources
def validate_source(source: str) -> None:
    """Syntax-check a ``PartitionSpec.source`` string (no filesystem I/O).

    Grammar: ``rmat:<n>[:<avg_degree>]`` | ``dataset:<name>`` | a file path
    to an on-disk graph (``.bin`` external CSR or ``.npz`` CSRGraph dump).
    """
    if not isinstance(source, str) or not source:
        raise ValueError(f"source must be a non-empty string, got {source!r}")
    if source.startswith("rmat:"):
        fields = source.split(":")[1:]
        if not 1 <= len(fields) <= 2:
            raise ValueError(
                f"bad source {source!r}: expected rmat:<n>[:<avg_degree>]"
            )
        try:
            n = int(fields[0])
            deg = float(fields[1]) if len(fields) == 2 else 16.0
        except ValueError:
            raise ValueError(
                f"bad source {source!r}: expected rmat:<n>[:<avg_degree>]"
            ) from None
        if n < 1 or deg <= 0:
            raise ValueError(
                f"bad source {source!r}: n must be >= 1 and avg_degree > 0"
            )
        return
    if source.startswith("dataset:"):
        from repro_torch.graph.generators import DATASETS

        name = source.split(":", 1)[1]
        if name not in DATASETS:
            raise ValueError(
                f"bad source {source!r}: unknown dataset {name!r} "
                f"(available: {', '.join(sorted(DATASETS))})"
            )
        return
    # anything else is a file path; colons are legal in POSIX paths, so no
    # scheme guessing - a missing file fails with a clear error at load time


def load_graph_source(source: str, *, seed: int = 0):
    """Resolve a spec ``source`` into a graph object.

    ``rmat:<n>[:<avg_degree>]`` generates a seeded R-MAT; ``dataset:<name>``
    loads a named benchmark dataset; anything else is a path - ``.npz`` loads
    a ``CSRGraph`` dump, everything else opens the file as a memory-mapped
    :class:`ExternalCSRGraph`.
    """
    validate_source(source)
    if source.startswith("rmat:"):
        from repro_torch.graph.generators import rmat_graph

        fields = source.split(":")[1:]
        n = int(fields[0])
        deg = float(fields[1]) if len(fields) == 2 else 16.0
        return rmat_graph(n, avg_degree=deg, seed=seed)
    if source.startswith("dataset:"):
        from repro_torch.graph.generators import load_dataset

        return load_dataset(source.split(":", 1)[1], seed=seed)
    return load_graph_file(source)


def load_graph_file(path: str):
    """Open an on-disk graph: ``.npz`` loads a ``CSRGraph`` dump resident,
    anything else is memory-mapped as an :class:`ExternalCSRGraph`."""
    if path.endswith(".npz"):
        return CSRGraph.load(path)
    return ExternalCSRGraph(path)
