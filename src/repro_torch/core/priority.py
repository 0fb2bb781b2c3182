"""Pluggable buffer-priority (eviction) strategies for buffered streaming.

Port of ``repro.core.priority``. CUTTANA's Algorithm 1 keeps a bounded
priority buffer and, on overflow, evicts (places) the *best-scored* vertex.
The strategy objects here decide that score, so the buffered policies
(:class:`~repro_torch.core.engine.BufferedPolicy`,
:class:`~repro_torch.core.engine.ShardedBufferedPolicy`) swap priorities per
spec without forking the engine:

* ``eq6`` (:class:`Eq6Priority`) - the paper's Eq. 6,
  ``deg/D_max + theta * assigned/deg``;
* ``completeness`` (:class:`CompletenessPriority`) - BuffCut-style
  neighbourhood completeness: the fraction of the neighbourhood already
  assigned, with a small degree term;
* ``gain`` (:class:`GainPriority`) - delayed decision: the margin between the
  best and runner-up partitions among the assigned neighbours.

Every scoring expression is literally the reference's (same operations on
the same operands, in the same order), so eviction orders are bit-identical,
including the one-ulp differences between the scalar and vectorised
completeness formulas. The strategies run on the host: each eviction depends
on the one before it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "BUFFER_STRATEGIES",
    "BufferPriority",
    "Eq6Priority",
    "CompletenessPriority",
    "GainPriority",
    "make_priority",
    "BufferStats",
]

# the reference's strategy names (repro_torch.api.spec validates against them)
BUFFER_STRATEGIES = ("eq6", "completeness", "gain")


class BufferPriority:
    """Eviction-priority strategy: higher score => evicted (placed) earlier.

    The buffer calls :meth:`score_counts` (scalar, at push time) and
    :meth:`score_counts_many` (vectorised, for a whole notified
    neighbourhood) with its flat ``(deg, assigned)`` bookkeeping. Strategies
    that need more signal set ``tracks_parts`` and receive the partition ids
    of assigned neighbours through ``on_push`` / ``on_notify`` /
    ``on_remove``. ``d_max`` doubles as the degree-bypass threshold (Thm. 1).
    """

    name: str = "base"
    tracks_parts: bool = False

    def __init__(self, d_max: int, theta: float = 1.0):
        self.d_max = max(int(d_max), 1)
        self.theta = float(theta)

    # ------------------------------------------------------------- scoring
    def score_counts(self, v: int, deg: int, assigned: int) -> float:
        raise NotImplementedError

    def score_counts_many(
        self, vs: np.ndarray, deg: np.ndarray, assigned: np.ndarray
    ) -> np.ndarray:
        raise NotImplementedError

    # ------------------------------------- partition tracking (tracks_parts)
    def on_push(self, v: int, nbr_parts: np.ndarray | None) -> None:
        """``v`` entered the buffer; ``nbr_parts`` is ``part_of`` over its
        neighbourhood (-1 for unassigned) or None without partition info."""

    def on_notify(self, vs: np.ndarray, parts) -> None:
        """Buffered occurrences ``vs`` each gained one assigned neighbour;
        ``parts`` is that neighbour's partition - a scalar or an array
        aligned with ``vs``."""

    def on_remove(self, v: int) -> None:
        """``v`` left the buffer (evicted or cascaded)."""


class Eq6Priority(BufferPriority):
    """CUTTANA Eq. 6: ``deg/D_max + theta * assigned/deg``."""

    name = "eq6"

    def score_counts(self, v: int, deg: int, assigned: int) -> float:
        return deg / self.d_max + self.theta * assigned / max(deg, 1)

    def score_counts_many(self, vs, deg, assigned) -> np.ndarray:
        return deg / self.d_max + (self.theta * assigned) / np.maximum(deg, 1)


class CompletenessPriority(BufferPriority):
    """BuffCut-style neighbourhood-completeness priority:
    ``theta * assigned/deg + W_deg * deg/D_max`` with a small ``W_deg``.

    The scalar form computes ``W_deg * deg / D_max`` and the vectorised form
    ``(W_deg / D_max) * deg``, as the reference does; the two can differ by
    one ulp, and the eviction order follows that ulp on ties."""

    name = "completeness"
    degree_weight = 0.25

    def score_counts(self, v: int, deg: int, assigned: int) -> float:
        return (
            self.theta * assigned / max(deg, 1)
            + self.degree_weight * deg / self.d_max
        )

    def score_counts_many(self, vs, deg, assigned) -> np.ndarray:
        return (self.theta * assigned) / np.maximum(deg, 1) + (
            self.degree_weight / self.d_max
        ) * deg


class GainPriority(BufferPriority):
    """Gain-aware delayed eviction: ``deg/D_max + theta * (best -
    runner_up)/deg`` over the per-partition counts of a buffered vertex's
    assigned neighbours. Without partition info (``on_push(v, None)``) the
    margin falls back to the assigned count, i.e. Eq. 6. Counts exist only
    while the vertex is buffered."""

    name = "gain"
    tracks_parts = True

    def __init__(self, d_max: int, theta: float = 1.0):
        super().__init__(d_max, theta)
        self._pc: dict[int, dict[int, int]] = {}

    # ------------------------------------------------------------- tracking
    def on_push(self, v: int, nbr_parts: np.ndarray | None) -> None:
        if nbr_parts is None:
            return
        assigned = np.asarray(nbr_parts)
        assigned = assigned[assigned >= 0]
        counts: dict[int, int] = {}
        if assigned.size:
            ps, cs = np.unique(assigned, return_counts=True)
            counts = dict(zip(ps.tolist(), cs.tolist()))
        self._pc[int(v)] = counts

    def on_notify(self, vs: np.ndarray, parts) -> None:
        pc = self._pc
        if np.isscalar(parts) or getattr(parts, "ndim", 1) == 0:
            p = int(parts)
            for v in vs.tolist():
                counts = pc.get(v)
                if counts is not None:
                    counts[p] = counts.get(p, 0) + 1
        else:
            for v, p in zip(vs.tolist(), np.asarray(parts).tolist()):
                counts = pc.get(v)
                if counts is not None:
                    counts[p] = counts.get(p, 0) + 1

    def on_remove(self, v: int) -> None:
        self._pc.pop(int(v), None)

    # ------------------------------------------------------------- scoring
    def _margin(self, v: int, assigned: int) -> float:
        counts = self._pc.get(int(v))
        if counts is None:
            return float(assigned)  # untracked push: Eq. 6 fallback
        if not counts:
            return 0.0
        best = 0
        second = 0
        for c in counts.values():
            if c > best:
                best, second = c, best
            elif c > second:
                second = c
        return float(best - second)

    def score_counts(self, v: int, deg: int, assigned: int) -> float:
        return (
            deg / self.d_max
            + self.theta * self._margin(v, assigned) / max(deg, 1)
        )

    def score_counts_many(self, vs, deg, assigned) -> np.ndarray:
        margins = np.fromiter(
            (self._margin(v, a) for v, a in zip(vs.tolist(), assigned.tolist())),
            dtype=np.float64,
            count=len(vs),
        )
        return deg / self.d_max + (self.theta * margins) / np.maximum(deg, 1)


_STRATEGIES = {
    "eq6": Eq6Priority,
    "completeness": CompletenessPriority,
    "gain": GainPriority,
}


def make_priority(name: str, d_max: int, theta: float = 1.0) -> BufferPriority:
    """A fresh strategy instance for ``name`` (strategies are stateful - one
    per buffer, never shared across shards)."""
    cls = _STRATEGIES.get(name)
    if cls is None:
        raise ValueError(
            f"unknown buffer strategy {name!r}; "
            f"expected one of {BUFFER_STRATEGIES}"
        )
    return cls(d_max, theta)


@dataclasses.dataclass
class BufferStats:
    """Eviction bookkeeping shared by the sequential and sharded buffered
    policies."""

    evictions: int = 0
    drained: int = 0
    bypass: int = 0
    peak: int = 0

    def observe_len(self, n: int) -> None:
        if n > self.peak:
            self.peak = n

    def to_telemetry(self, strategy: str) -> dict:
        return {
            "buffer_evictions": self.evictions,
            "buffer_drained": self.drained,
            "buffer_peak": self.peak,
            "degree_bypass": self.bypass,
            "buffer_strategy": strategy,
        }
