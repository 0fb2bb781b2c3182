"""Delta-varint block codec for the v2 external CSR format (port of
``repro.graph.compress``; the encoded bytes are the reference's).

The v2 on-disk format (see :mod:`repro_torch.graph.external`) stores each vertex's sorted neighbour list as a
sequence of fixed-capacity *blocks*: the first value of every block is an
absolute vertex id, the rest are deltas against the previous value. Rows are
strictly sorted with no duplicates, so every delta is >= 1 and small on
power-law graphs — LEB128 varints then pack the common case into 1-2 bytes
instead of the raw 4 of an int32.

Everything here is NumPy-vectorised: encode/decode cost is a handful of
masked passes bounded by the *longest* varint in the batch (<= 9 bytes for
any non-negative int64), never a per-edge Python loop. The codec is pure
(arrays in, arrays out) and holds this contract:

* ``decode(encode(x)) == x`` for any strictly-row-sorted adjacency;
* a truncated, bit-flipped, or count-inconsistent stream raises ``ValueError``
  rather than decoding to garbage.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "DEFAULT_BLOCK_CAP",
    "MAX_VARINT_BYTES",
    "varint_encode",
    "varint_decode",
    "encode_adjacency",
    "decode_adjacency",
]

# Restart interval: every block_cap-th value within a row is stored as an
# absolute id so a corrupt delta cannot poison more than one block. 64 keeps
# the absolute-value overhead under ~2% on power-law rows while bounding the
# blast radius of a bad byte.
DEFAULT_BLOCK_CAP = 64

# Any non-negative int64 fits in ceil(63/7) = 9 LEB128 bytes.
MAX_VARINT_BYTES = 9


def varint_sizes(vals: np.ndarray) -> np.ndarray:
    """Encoded byte length of each value (int64[m], each in [1, 9])."""
    vals = np.asarray(vals, dtype=np.int64)
    nb = np.ones(vals.shape[0], dtype=np.int64)
    for j in range(1, MAX_VARINT_BYTES):
        nb += vals >= np.int64(1) << np.int64(7 * j)
    return nb


def varint_encode(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """LEB128-encode non-negative int64 values.

    Returns ``(buf, nb)``: the packed uint8 stream and the per-value byte
    lengths (``nb.sum() == buf.shape[0]``).
    """
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    if vals.size == 0:
        return np.empty(0, dtype=np.uint8), np.empty(0, dtype=np.int64)
    if int(vals.min()) < 0:
        raise ValueError("varint_encode: negative value")
    nb = varint_sizes(vals)
    starts = np.cumsum(nb) - nb
    out = np.empty(int(nb.sum()), dtype=np.uint8)
    for j in range(int(nb.max())):
        m = nb > j
        byte = (vals[m] >> np.int64(7 * j)) & np.int64(0x7F)
        cont = np.where(nb[m] - 1 > j, np.int64(0x80), np.int64(0))
        out[starts[m] + j] = (byte | cont).astype(np.uint8)
    return out, nb


def varint_decode(
    buf: np.ndarray, count: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a packed LEB128 stream back to int64 values.

    Returns ``(vals, starts)`` where ``starts[i]`` is the byte offset of
    value ``i`` inside ``buf``. Raises ``ValueError`` on a truncated stream
    (last byte has its continuation bit set), an over-long varint, or — when
    ``count`` is given — a value count that does not match.
    """
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if buf.size == 0:
        if count not in (None, 0):
            raise ValueError(
                f"varint stream empty, expected {count} values"
            )
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    ends = np.flatnonzero(buf < 0x80)
    if ends.size == 0 or int(ends[-1]) != buf.shape[0] - 1:
        raise ValueError("varint stream truncated: missing terminator byte")
    if count is not None and ends.size != count:
        raise ValueError(
            f"varint count mismatch: decoded {ends.size}, expected {count}"
        )
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    width = int(lens.max())
    if width > MAX_VARINT_BYTES:
        raise ValueError(
            f"varint longer than {MAX_VARINT_BYTES} bytes (corrupt stream)"
        )
    vals = (buf[starts] & np.uint8(0x7F)).astype(np.int64)
    for j in range(1, width):
        m = lens > j
        vals[m] |= (buf[starts[m] + j] & np.uint8(0x7F)).astype(np.int64) << (
            np.int64(7 * j)
        )
    return vals, starts


def _restart_mask(degs: np.ndarray, block_cap: int) -> np.ndarray:
    """bool[m]: True where a value opens a block (stored as an absolute id)."""
    degs = np.asarray(degs, dtype=np.int64)
    m = int(degs.sum())
    row_first = np.cumsum(degs) - degs
    idx_in_row = np.arange(m, dtype=np.int64) - np.repeat(row_first, degs)
    return (idx_in_row % block_cap) == 0


def encode_adjacency(
    flat: np.ndarray, degs: np.ndarray, block_cap: int = DEFAULT_BLOCK_CAP
) -> tuple[np.ndarray, np.ndarray]:
    """Block-delta + varint encode a concatenation of sorted neighbour rows.

    ``flat`` holds the rows back to back (``degs[i]`` values each); every row
    must be strictly increasing (the CSR invariant). Returns
    ``(data, row_bytes)``: the packed uint8 stream and the encoded byte length
    of each row (``row_bytes.sum() == data.shape[0]``).
    """
    if block_cap < 1:
        raise ValueError(f"block_cap must be >= 1, got {block_cap}")
    flat = np.ascontiguousarray(flat, dtype=np.int64)
    degs = np.asarray(degs, dtype=np.int64)
    if flat.shape[0] != int(degs.sum()):
        raise ValueError(
            f"flat has {flat.shape[0]} values but degs sums to {int(degs.sum())}"
        )
    if flat.size == 0:
        return np.empty(0, dtype=np.uint8), np.zeros(degs.shape[0], np.int64)
    restart = _restart_mask(degs, block_cap)
    prev = np.empty_like(flat)
    prev[0] = 0
    prev[1:] = flat[:-1]
    enc = np.where(restart, flat, flat - prev)
    if int(enc.min()) < 0 or (enc[~restart] <= 0).any():
        raise ValueError(
            "adjacency rows must be strictly sorted non-negative ids"
        )
    data, nb = varint_encode(enc)
    row_bytes = np.bincount(
        np.repeat(np.arange(degs.shape[0], dtype=np.int64), degs),
        weights=nb,
        minlength=degs.shape[0],
    ).astype(np.int64)
    return data, row_bytes


def decode_adjacency(
    data: np.ndarray,
    degs: np.ndarray,
    block_cap: int = DEFAULT_BLOCK_CAP,
    row_byte_off: np.ndarray | None = None,
) -> np.ndarray:
    """Inverse of :func:`encode_adjacency`: recover the flat neighbour values.

    ``row_byte_off`` (int64[r+1], optional) is the expected byte offset of
    each row inside ``data``; when given, the decoded stream's row boundaries
    are validated against it so a corrupt block cannot silently shift
    neighbours between rows.
    """
    degs = np.asarray(degs, dtype=np.int64)
    count = int(degs.sum())
    vals, starts = varint_decode(data, count=count)
    if count == 0:
        return vals
    restart = _restart_mask(degs, block_cap)
    # segmented un-delta: within each block, out[j] = abs_at_block_start +
    # sum of deltas since; cumsum once, subtract each block's base.
    cs = np.cumsum(vals)
    seg_starts = np.flatnonzero(restart)
    base = cs[seg_starts] - vals[seg_starts]
    seg_id = np.cumsum(restart) - 1
    out = cs - base[seg_id]
    if row_byte_off is not None:
        row_first = np.cumsum(degs) - degs
        nz = degs > 0
        expect = np.asarray(row_byte_off, dtype=np.int64)
        if int(expect[-1]) != data.shape[0] or not np.array_equal(
            starts[row_first[nz]], expect[:-1][nz]
        ):
            raise ValueError(
                "compressed row offsets inconsistent with block index "
                "(corrupt data region)"
            )
    return out
