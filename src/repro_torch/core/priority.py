"""Buffer-eviction priority for CUTTANA's buffered streaming (paper Eq. 6).

Port of ``repro.core.priority`` limited to the paper's ``eq6`` strategy;
``completeness`` and ``gain`` (``cuttana-buffcut``) arrive with slice 4 of
the port. The scoring expressions are literally the reference's, so the
eviction order is bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BUFFER_STRATEGIES", "Eq6Priority", "make_priority", "BufferStats"]

# the reference's strategy names; specs accept all of them
BUFFER_STRATEGIES = ("eq6", "completeness", "gain")


class Eq6Priority:
    """CUTTANA Eq. 6: ``deg/D_max + theta * assigned/deg``. Higher score =>
    evicted (placed) earlier. ``d_max`` doubles as the degree-bypass
    threshold (Thm. 1)."""

    name = "eq6"
    tracks_parts = False

    def __init__(self, d_max: int, theta: float = 1.0):
        self.d_max = max(int(d_max), 1)
        self.theta = float(theta)

    def score_counts(self, v: int, deg: int, assigned: int) -> float:
        return deg / self.d_max + self.theta * assigned / max(deg, 1)

    def score_counts_many(self, vs, deg, assigned) -> np.ndarray:
        return deg / self.d_max + (self.theta * assigned) / np.maximum(deg, 1)


def make_priority(name: str, d_max: int, theta: float = 1.0) -> Eq6Priority:
    """A fresh strategy instance for ``name``."""
    if name == "eq6":
        return Eq6Priority(d_max, theta)
    if name in BUFFER_STRATEGIES:
        raise ValueError(
            f"buffer strategy {name!r} is not ported yet: it arrives with "
            "slice 4 of the port (cuttana-buffcut); only 'eq6' runs now"
        )
    raise ValueError(
        f"unknown buffer strategy {name!r}; expected one of {BUFFER_STRATEGIES}"
    )


@dataclasses.dataclass
class BufferStats:
    """Eviction bookkeeping of the buffered policy."""

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
