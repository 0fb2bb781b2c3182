"""Wrappers of the partition-score kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/partition_score.cu``) or the call raises; a CPU tensor takes the
plain PyTorch version in ``ref.py``. There is no fallback from one to the
other. ``launches`` counts the launches of the sequential entries
(``fennel_scores``, ``fennel_scores_gather``; the port of
``fennel_scores_pallas``), ``sharded_launches`` those of the sharded entries
(``fennel_scores_sharded``, ``fennel_scores_sharded_gather``; the port of
``fennel_scores_sharded_pallas``). The rows entries (``fennel_scores_rows``,
``fennel_scores_sharded_rows``), which score a chunk-local CSR copied to the
card for a memory-mapped graph, count in ``rows_launches`` and
``sharded_rows_launches``. CPU calls count in none.

The kernel splits a call by entries, not by rows (``csrc/partition_score.cu``):
the rows are cut into groups, one cluster of ``CLUSTER_BLOCKS`` blocks each;
a group's rows and entries form one path (a row's end item after its last
entry), cut into one share a block; the block holding a row's end item
writes its scores, and a block whose share ends inside a row adds its counts
of that row to it. :func:`group_rows` and :func:`tile_plan` give that split
from the shapes and the degrees on the host, for the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import check_tensor as _check
from repro_torch.kernels.partition_score import build
from repro_torch.kernels.partition_score.ref import (
    fennel_scores_gather_ref,
    fennel_scores_ref,
    fennel_scores_rows_ref,
    fennel_scores_sharded_gather_ref,
    fennel_scores_sharded_ref,
    fennel_scores_sharded_rows_ref,
)

__all__ = [
    "CLUSTER_BLOCKS",
    "COUNT_INTS",
    "MAX_K",
    "THREADS",
    "UNROLL",
    "WHOLE_ROW",
    "fennel_scores",
    "fennel_scores_gather",
    "fennel_scores_rows",
    "fennel_scores_sharded",
    "fennel_scores_sharded_gather",
    "fennel_scores_sharded_rows",
    "group_rows",
    "launches",
    "reset",
    "rows_launches",
    "sharded_launches",
    "sharded_rows_launches",
    "tile_plan",
]

# the kernel's split (csrc kThreads, kClusterBlocks, kUnroll, kWholeRow,
# kCountInts): blocks of THREADS threads, CLUSTER_BLOCKS of them sharing one
# group of at most THREADS rows, UNROLL path items a thread in flight, no row
# of at most WHOLE_ROW items split between blocks, at most COUNT_INTS int32
# counters (group rows x K) a block
THREADS = 512
CLUSTER_BLOCKS = 16
UNROLL = 4
WHOLE_ROW = 4096
COUNT_INTS = 16384
# one row of K counters must fit COUNT_INTS (csrc kMaxK)
MAX_K = 12288
# rows are indexed by a C int, and the grid (CLUSTER_BLOCKS blocks a group)
# must fit grid x
_MAX_ROWS = 2**31 - 1


def group_rows(num_rows: int, k: int, width: int | None = None) -> int:
    """Rows of one cluster's group: one a thread in the block's scan, at most
    ``COUNT_INTS // k`` (their counters), at most ``num_rows``; for rows of a
    fixed ``width`` (the dense entries) no more than give each thread of the
    cluster ``UNROLL`` items. The kernel's ``group_rows``."""
    g = min(THREADS, COUNT_INTS // k)
    if width is not None:
        g = min(g, max(1, CLUSTER_BLOCKS * THREADS * UNROLL // (width + 1)))
    return min(g, num_rows)


def tile_plan(degrees: np.ndarray, k: int, width: int | None = None) -> dict:
    """The kernel's split of one call whose rows have ``degrees`` (in row
    order). A group's path is its rows' entries, each row followed by its
    end item; block ``b`` of the group's cluster takes items ``bounds[g, b]
    : bounds[g, b + 1]``, where ``path * b // CLUSTER_BLOCKS`` moves back to
    the start of its row unless that row holds more than ``WHOLE_ROW``
    items, so only such rows are split. Returns ``group_rows``; ``blocks`` in
    the grid; ``bounds`` [groups, CLUSTER_BLOCKS + 1]; per row ``ends`` (its
    end item's position in its group's path), ``first_block`` and ``owner``
    (the blocks of its cluster holding its first item and its end item; the
    owner writes its scores) and ``split`` (its items lie in more than one
    block)."""
    degrees = np.asarray(degrees, dtype=np.int64)
    c = degrees.shape[0]
    g = group_rows(c, k, width)
    groups = -(-c // g)
    ends = np.empty(c, np.int64)
    bounds = np.empty((groups, CLUSTER_BLOCKS + 1), np.int64)
    first = np.empty(c, np.int64)
    owner = np.empty(c, np.int64)
    for gi in range(groups):
        sl = slice(gi * g, min(c, (gi + 1) * g))
        e = np.cumsum(degrees[sl] + 1) - 1
        starts = e - degrees[sl]
        path = int(e[-1]) + 1
        at = np.array([path * b // CLUSTER_BLOCKS for b in range(CLUSTER_BLOCKS)])
        r = np.searchsorted(e, at, side="left")  # the row holding each nominal bound
        short = e[r] - starts[r] < WHOLE_ROW
        b = np.append(np.where(short, starts[r], at), path)
        ends[sl], bounds[gi] = e, b
        first[sl] = np.searchsorted(b, starts, side="right") - 1
        owner[sl] = np.searchsorted(b, e, side="right") - 1
    return {"group_rows": g, "blocks": groups * CLUSTER_BLOCKS, "ends": ends,
            "bounds": bounds, "first_block": first, "owner": owner, "split": first != owner}


launches = 0
sharded_launches = 0
rows_launches = 0
sharded_rows_launches = 0
# device -> int64 arange, the rows entries' batch (row r is local row r)
_row_ids_cache: dict = {}


def reset() -> None:
    """Zero the launch counts."""
    global launches, sharded_launches, rows_launches, sharded_rows_launches
    launches = 0
    sharded_launches = 0
    rows_launches = 0
    sharded_rows_launches = 0


def _check_k(sizes: torch.Tensor) -> int:
    k = sizes.shape[-1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K must be in [1, {MAX_K}], got {k}")
    return k


def _check_graph(indptr, indices, part_of, batch, device) -> None:
    _check("indptr", indptr, torch.int64, 1, device)
    _check("indices", indices, torch.int32, 1, device)
    _check("part_of", part_of, torch.int32, 1, device)
    _check("batch", batch, torch.int64, 1, device)
    if part_of.shape[0] != indptr.shape[0] - 1:
        raise ValueError(
            f"part_of has {part_of.shape[0]} entries for a graph of "
            f"{indptr.shape[0] - 1} vertices"
        )
    if batch.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per call, got {batch.shape[0]}")


def _check_rows(local_indptr, cols, part_of, device) -> int:
    """Check a chunk-local CSR (row ``r`` is ``cols[local_indptr[r] :
    local_indptr[r + 1]]``); returns its row count. The values are read for
    a CPU tensor only: on the card that read would cost a synchronisation
    a chunk."""
    _check("local_indptr", local_indptr, torch.int64, 1, device)
    _check("cols", cols, torch.int32, 1, device)
    _check("part_of", part_of, torch.int32, 1, device)
    c = local_indptr.shape[0] - 1
    if not 0 <= c <= _MAX_ROWS:
        raise ValueError(f"local_indptr must hold 1 to {_MAX_ROWS + 1} offsets, got {c + 1}")
    if device.type == "cpu":
        if (
            int(local_indptr[0]) != 0
            or int(local_indptr[-1]) != cols.shape[0]
            or bool((local_indptr[1:] < local_indptr[:-1]).any())
        ):
            raise ValueError(f"local_indptr must rise from 0 to len(cols) = {cols.shape[0]}")
        if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= part_of.shape[0]):
            raise ValueError(f"cols must be vertex ids in [0, {part_of.shape[0]})")
    return c


def _row_ids(c: int, device: torch.device) -> torch.Tensor:
    """int64[c] ``0..c-1`` on ``device``, from a cached arange (grown to a
    power of two), so a rows entry is the gather entry's launch with
    ``batch[r] = r``."""
    key = str(device)
    ids = _row_ids_cache.get(key)
    if ids is None or ids.shape[0] < c:
        ids = torch.arange(max(1 << (c - 1).bit_length(), 1024), dtype=torch.int64, device=device)
        _row_ids_cache[key] = ids
    return ids[:c]


def _launch(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"partition_score kernel launch failed: CUDA error {err}")


def fennel_scores_gather(
    indptr: torch.Tensor,  # int64[V+1]
    indices: torch.Tensor,  # int32[nnz]
    part_of: torch.Tensor,  # int32[V], -1 = unassigned
    batch: torch.Tensor,  # int64[C] vertex ids of the rows
    sizes: torch.Tensor,  # float32[K]
    alpha: float,
    gamma: float,
) -> torch.Tensor:
    """scores f32[C, K] for the CSR rows of ``batch`` (the engine's call)."""
    global launches
    device = indptr.device
    _check_graph(indptr, indices, part_of, batch, device)
    _check("sizes", sizes, torch.float32, 1, device)
    k = _check_k(sizes)
    if device.type == "cpu":
        return fennel_scores_gather_ref(indptr, indices, part_of, batch, sizes, alpha, gamma)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    c = batch.shape[0]
    out = torch.empty((c, k), dtype=torch.float32, device=device)
    if c:
        _launch(
            build.library().partition_score_gather,
            indptr.data_ptr(), indices.data_ptr(), part_of.data_ptr(),
            batch.data_ptr(), c, sizes.data_ptr(), k,
            float(alpha * gamma), float(gamma - 1.0), out.data_ptr(),
        )
        launches += 1
    return out


def fennel_scores_rows(
    local_indptr: torch.Tensor,  # int64[C+1] offsets of the chunk's rows in cols
    cols: torch.Tensor,  # int32[nnz] the rows' neighbour ids
    part_of: torch.Tensor,  # int32[V], -1 = unassigned
    sizes: torch.Tensor,  # float32[K]
    alpha: float,
    gamma: float,
) -> torch.Tensor:
    """scores f32[C, K] for a chunk's rows copied to the device as a
    chunk-local CSR (the engine's call for a memory-mapped graph). One
    launch of the gather entry's kernel with row ``r`` read from
    ``local_indptr[r] .. local_indptr[r + 1]``."""
    global rows_launches
    device = local_indptr.device
    c = _check_rows(local_indptr, cols, part_of, device)
    _check("sizes", sizes, torch.float32, 1, device)
    k = _check_k(sizes)
    if device.type == "cpu":
        return fennel_scores_rows_ref(local_indptr, cols, part_of, sizes, alpha, gamma)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((c, k), dtype=torch.float32, device=device)
    if c:
        _launch(
            build.library().partition_score_gather,
            local_indptr.data_ptr(), cols.data_ptr(), part_of.data_ptr(),
            _row_ids(c, device).data_ptr(), c, sizes.data_ptr(), k,
            float(alpha * gamma), float(gamma - 1.0), out.data_ptr(),
        )
        rows_launches += 1
    return out


def fennel_scores(
    nbr_parts: torch.Tensor,  # int32[B, D], -1 padding
    sizes: torch.Tensor,  # float32[K]
    alpha: float,
    gamma: float = 1.5,
) -> torch.Tensor:
    """scores f32[B, K] for a dense matrix of neighbour partition ids (the
    reference's ``fennel_scores`` signature)."""
    global launches
    device = nbr_parts.device
    _check("nbr_parts", nbr_parts, torch.int32, 2, device)
    _check("sizes", sizes, torch.float32, 1, device)
    k = _check_k(sizes)
    if device.type == "cpu":
        return fennel_scores_ref(nbr_parts, sizes, alpha, gamma)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    b, d = nbr_parts.shape
    out = torch.empty((b, k), dtype=torch.float32, device=device)
    if b:
        _launch(
            build.library().partition_score_dense,
            nbr_parts.data_ptr(), b, d, sizes.data_ptr(), k,
            float(alpha * gamma), float(gamma - 1.0), out.data_ptr(),
        )
        launches += 1
    return out


def fennel_scores_sharded_gather(
    indptr: torch.Tensor,  # int64[V+1]
    indices: torch.Tensor,  # int32[nnz]
    part_of: torch.Tensor,  # int32[V], -1 = unassigned
    batch: torch.Tensor,  # int64[total] candidates, shard after shard
    shard_start: torch.Tensor,  # int64[S+1] first row of each shard, then total
    sizes: torch.Tensor,  # float32[S, K] one size row per shard
    alpha: float,
    gamma: float,
) -> torch.Tensor:
    """scores f32[total, K] for the CSR rows of a superstep's candidates;
    row ``r`` is penalised by the size row of the shard that holds it (the
    parallel engine's call, one per superstep).

    ``shard_start`` must rise from 0 to ``total``; an empty shard repeats a
    bound. Its values are checked here for a CPU tensor only: reading them
    from the card would cost a synchronisation per superstep, and the kernel
    clamps the shard it finds, so a bad ``shard_start`` there picks a wrong
    size row but reads nothing out of bounds."""
    global sharded_launches
    device = indptr.device
    _check_graph(indptr, indices, part_of, batch, device)
    _check("shard_start", shard_start, torch.int64, 1, device)
    _check("sizes", sizes, torch.float32, 2, device)
    k = _check_k(sizes)
    s = sizes.shape[0]
    if s < 1 or shard_start.shape[0] != s + 1:
        raise ValueError(
            f"shard_start must have S+1 = {s + 1} entries for {s} size rows, "
            f"got {shard_start.shape[0]}"
        )
    total = batch.shape[0]
    if device.type == "cpu":
        if (
            int(shard_start[0]) != 0
            or int(shard_start[-1]) != total
            or bool((shard_start[1:] < shard_start[:-1]).any())
        ):
            raise ValueError(f"shard_start must rise from 0 to {total}")
        return fennel_scores_sharded_gather_ref(
            indptr, indices, part_of, batch, shard_start, sizes, alpha, gamma
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((total, k), dtype=torch.float32, device=device)
    if total:
        _launch(
            build.library().partition_score_sharded_gather,
            indptr.data_ptr(), indices.data_ptr(), part_of.data_ptr(),
            batch.data_ptr(), shard_start.data_ptr(), s, total,
            sizes.data_ptr(), k, float(alpha * gamma), float(gamma - 1.0),
            out.data_ptr(),
        )
        sharded_launches += 1
    return out


def fennel_scores_sharded_rows(
    local_indptr: torch.Tensor,  # int64[total+1] offsets of the rows in cols
    cols: torch.Tensor,  # int32[nnz] the rows' neighbour ids
    part_of: torch.Tensor,  # int32[V], -1 = unassigned
    shard_start: torch.Tensor,  # int64[S+1] first row of each shard, then total
    sizes: torch.Tensor,  # float32[S, K] one size row per shard
    alpha: float,
    gamma: float,
) -> torch.Tensor:
    """scores f32[total, K] for a superstep's candidate rows copied to the
    device as one local CSR, shard after shard (the parallel engine's call
    for a memory-mapped graph). One launch of the sharded gather entry's
    kernel; ``shard_start`` as in :func:`fennel_scores_sharded_gather`."""
    global sharded_rows_launches
    device = local_indptr.device
    total = _check_rows(local_indptr, cols, part_of, device)
    _check("shard_start", shard_start, torch.int64, 1, device)
    _check("sizes", sizes, torch.float32, 2, device)
    k = _check_k(sizes)
    s = sizes.shape[0]
    if s < 1 or shard_start.shape[0] != s + 1:
        raise ValueError(
            f"shard_start must have S+1 = {s + 1} entries for {s} size rows, "
            f"got {shard_start.shape[0]}"
        )
    if device.type == "cpu":
        if (
            int(shard_start[0]) != 0
            or int(shard_start[-1]) != total
            or bool((shard_start[1:] < shard_start[:-1]).any())
        ):
            raise ValueError(f"shard_start must rise from 0 to {total}")
        return fennel_scores_sharded_rows_ref(
            local_indptr, cols, part_of, shard_start, sizes, alpha, gamma
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((total, k), dtype=torch.float32, device=device)
    if total:
        _launch(
            build.library().partition_score_sharded_gather,
            local_indptr.data_ptr(), cols.data_ptr(), part_of.data_ptr(),
            _row_ids(total, device).data_ptr(), shard_start.data_ptr(), s, total,
            sizes.data_ptr(), k, float(alpha * gamma), float(gamma - 1.0),
            out.data_ptr(),
        )
        sharded_rows_launches += 1
    return out


def fennel_scores_sharded(
    nbr_parts: torch.Tensor,  # int32[S, C, D], -1 padding
    sizes: torch.Tensor,  # float32[S, K]
    alpha: float,
    gamma: float = 1.5,
) -> torch.Tensor:
    """scores f32[S, C, K]: shard ``s`` scores its rows against its own size
    row (the reference's ``fennel_scores_sharded`` signature)."""
    global sharded_launches
    device = nbr_parts.device
    _check("nbr_parts", nbr_parts, torch.int32, 3, device)
    _check("sizes", sizes, torch.float32, 2, device)
    k = _check_k(sizes)
    s, c, d = nbr_parts.shape
    if sizes.shape[0] != s:
        raise ValueError(f"sizes has {sizes.shape[0]} size rows for {s} shards")
    if s * c > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per call, got {s * c}")
    if device.type == "cpu":
        return fennel_scores_sharded_ref(nbr_parts, sizes, alpha, gamma)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((s, c, k), dtype=torch.float32, device=device)
    if s * c:
        _launch(
            build.library().partition_score_sharded_dense,
            nbr_parts.data_ptr(), s, c, d, sizes.data_ptr(), k,
            float(alpha * gamma), float(gamma - 1.0), out.data_ptr(),
        )
        sharded_launches += 1
    return out
