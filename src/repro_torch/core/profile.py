"""Lightweight per-superstep profiling for the sharded engine (port of
``repro.core.profile``).

The superstep core splits each round into phases and feeds their durations
here; the aggregate lands in ``telemetry["profile"]`` (and from there in
:class:`repro_torch.api.result.PartitionResult`). Phases:

* ``prep``    - frontier expansion (CSR slicing + in-shard correction
  pairs). Prefetched one superstep ahead, so with >= 2 workers this mostly
  measures *wait* on an already-running task - small prep_s is the overlap
  working, not the expansion being free.
* ``score``   - assigned-neighbour histogramming: the one sharded
  partition-score call per superstep on the main thread (the kernel on the
  card, its plain version on the CPU), the copy of its counts to the host,
  and each shard task's read of its candidates' current partitions.
* ``place``   - wave-vectorised placement inside the shard tasks.
* ``exchange`` - the boundary exchange: committing assignments/loads to the
  shared state and counting cross-shard conflicts.
* ``merge``   - post-boundary merges: the chained sub-partition pass and the
  buffered policy's buffer notifications.

``score_s``/``place_s`` are summed across shard tasks, so with W workers
they may exceed wall time; ``parallel_wall_s`` is the actual start-to-join
wall of the concurrent section, and ``queue_wait_s`` the summed lag between
task submission and task start (pool saturation indicator).

Cost: a few float adds per superstep - safe to leave on unconditionally.
"""
from __future__ import annotations

PHASES = ("prep", "score", "place", "exchange", "merge")


class SuperstepProfiler:
    def __init__(self, workers: int, keep: int = 64):
        self.workers = int(workers)
        self.totals = {p: 0.0 for p in PHASES}
        self.parallel_wall_s = 0.0
        self.queue_wait_s = 0.0
        self.supersteps = 0
        self._keep = int(keep)
        self._rows: list[dict] = []

    def record(self, *, parallel_wall: float = 0.0, **phase_seconds) -> None:
        """Account one superstep. ``phase_seconds`` keys must be in
        :data:`PHASES`; omitted phases count as zero."""
        self.supersteps += 1
        for phase, dt in phase_seconds.items():
            self.totals[phase] += dt
        self.parallel_wall_s += parallel_wall
        if len(self._rows) < self._keep:
            row = {p: round(phase_seconds.get(p, 0.0), 6) for p in PHASES}
            row["parallel_wall"] = round(parallel_wall, 6)
            self._rows.append(row)

    def add(self, phase: str, seconds: float) -> None:
        """Accumulate time into a phase outside the per-superstep record
        (prefetch waits, ingest scans, chain flushes)."""
        self.totals[phase] += seconds

    def add_queue_wait(self, seconds: float) -> None:
        self.queue_wait_s += seconds

    def to_dict(self) -> dict:
        out = {
            "workers": self.workers,
            "supersteps": self.supersteps,
            "parallel_wall_s": round(self.parallel_wall_s, 6),
            "queue_wait_s": round(self.queue_wait_s, 6),
        }
        for p in PHASES:
            out[f"{p}_s"] = round(self.totals[p], 6)
        # first _keep supersteps verbatim: enough to see warmup + steady state
        # without unbounded growth on million-superstep runs
        out["per_superstep"] = list(self._rows)
        return out
