"""Plain PyTorch versions of the partition-score kernel.

``scores[r, k] = hist[r, k] - alpha*gamma*max(sizes[k], 0)^(gamma-1)`` where
``hist[r, k]`` counts row ``r``'s neighbour partition ids equal to ``k``
(ids outside ``[0, K)``, e.g. the -1 of an unassigned neighbour, are not
counted). The histogram is one ``bincount`` of ``row*K + p``; the penalty is
float32, like the kernel's. The wrapper in ``ops.py`` takes these for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernel against them.
"""
from __future__ import annotations

import torch


def _scores(rows: torch.Tensor, parts: torch.Tensor, num_rows: int,
            sizes: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    k = sizes.shape[0]
    keep = (parts >= 0) & (parts < k)
    keys = rows[keep] * k + parts[keep].to(torch.int64)
    hist = torch.bincount(keys, minlength=num_rows * k).reshape(num_rows, k)
    penalty = (alpha * gamma) * torch.pow(torch.clamp(sizes, min=0.0), gamma - 1.0)
    return hist.to(torch.float32) - penalty


def expand_rows(indptr: torch.Tensor, batch: torch.Tensor):
    """``(rows, pos)`` of a batch's CSR entries: flat entry ``j`` is
    ``indices[pos[j]]`` and belongs to batch row ``rows[j]``."""
    starts = indptr[batch]
    degs = indptr[batch + 1] - starts
    rows = torch.repeat_interleave(
        torch.arange(batch.shape[0], dtype=torch.int64, device=batch.device), degs
    )
    first = torch.cumsum(degs, 0) - degs  # flat offset of each row's first entry
    pos = torch.arange(rows.shape[0], dtype=torch.int64, device=batch.device)
    pos += (starts - first)[rows]
    return rows, pos


def fennel_scores_gather_ref(indptr, indices, part_of, batch, sizes,
                             alpha: float, gamma: float) -> torch.Tensor:
    """The gather entry: row ``r`` covers the CSR row of vertex ``batch[r]``
    and reads ``part_of`` of each neighbour."""
    rows, pos = expand_rows(indptr, batch)
    parts = part_of[indices[pos].to(torch.int64)]
    return _scores(rows, parts, batch.shape[0], sizes, alpha, gamma)


def fennel_scores_ref(nbr_parts, sizes, alpha: float, gamma: float) -> torch.Tensor:
    """The dense entry: row ``r`` is ``nbr_parts[r, :]`` (-1 padding)."""
    b, d = nbr_parts.shape
    rows = torch.arange(b, dtype=torch.int64, device=nbr_parts.device)
    rows = rows.repeat_interleave(d)
    return _scores(rows, nbr_parts.reshape(-1), b, sizes, alpha, gamma)
