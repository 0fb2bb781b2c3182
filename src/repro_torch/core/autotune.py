"""Auto-tuned sharding: resolve ``num_shards=0`` ("auto") and ``chunk=0``
from the scaling suite's latency-vs-boundary-conflicts curve (port of
``repro.core.autotune``).

The scaling benchmark (``benchmarks/scaling.py``) records, per algorithm and
shard count, the phase-1 stream latency and the boundary-conflict count.
More shards buy concurrency but raise cross-shard staleness (conflicts), so
the useful operating point is the *knee*: the smallest configuration whose
latency is within a slack of the best. ``benchmarks.scaling`` serialises
that curve plus the chosen knee per algorithm into ``TUNING_partition.json``;
at run time :func:`resolve` consumes the artifact when a caller asks for
``num_shards=0`` / ``"auto"`` (checked in ``$REPRO_TUNING_PATH``, the
working directory, then the repo root). Without an artifact a conservative
CPU-count heuristic applies, so auto mode never fails - it only gets better
when the suite has run.

The port reads the same ``TUNING_partition.json`` as the reference, so
``num_shards="auto"`` resolves to the same shard count in both packages.
That artifact's knee was measured on a CPU host; it is no tuning for a card.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

DEFAULT_FILENAME = "TUNING_partition.json"
ENV_PATH = "REPRO_TUNING_PATH"
_LATENCY_SLACK = 0.10

__all__ = [
    "Tuning",
    "choose_num_shards",
    "choose_chunk",
    "build_artifact",
    "load_artifact",
    "resolve",
]


@dataclasses.dataclass(frozen=True)
class Tuning:
    """Resolved parallel knobs plus where they came from (``explicit``,
    ``artifact:<path>`` or ``heuristic``) - recorded in telemetry so a run
    is attributable to its tuning source."""

    num_shards: int
    chunk: int
    source: str


def choose_num_shards(rows: list[dict], latency_slack: float = _LATENCY_SLACK) -> int | None:
    """Knee of the latency-vs-conflicts curve: among shard counts whose
    stream latency is within ``latency_slack`` of the fastest, pick the one
    with the fewest boundary conflicts (ties toward fewer shards)."""
    cand = [
        r
        for r in rows
        if isinstance(r.get("stream_seconds"), (int, float))
        and int(r.get("num_shards", 0)) >= 1
    ]
    if not cand:
        return None
    best = min(r["stream_seconds"] for r in cand)
    ok = [r for r in cand if r["stream_seconds"] <= best * (1.0 + latency_slack)]
    ok.sort(key=lambda r: (int(r.get("boundary_conflicts", 0)), int(r["num_shards"])))
    return int(ok[0]["num_shards"])


def choose_chunk(rows: list[dict]) -> int | None:
    """Fastest chunk size from a chunk-sweep (rows carrying a ``chunk``
    field); ties toward the smaller chunk (lower staleness)."""
    cand = [
        r
        for r in rows
        if isinstance(r.get("stream_seconds"), (int, float)) and int(r.get("chunk", 0)) >= 1
    ]
    if not cand:
        return None
    cand.sort(key=lambda r: (r["stream_seconds"], int(r["chunk"])))
    return int(cand[0]["chunk"])


def build_artifact(rows_by_algo: dict[str, list[dict]], chunk_rows: list[dict] | None = None) -> dict:
    """Serialisable tuning artifact from scaling-suite rows grouped by
    algorithm. ``chosen`` holds the per-algorithm knee plus a ``default``
    (worst-case knee across algorithms, so an unknown algorithm still gets a
    sane shard count)."""
    chosen: dict[str, dict] = {}
    curves: dict[str, list[dict]] = {}
    chunk = choose_chunk(chunk_rows or [])
    for algo, rows in sorted(rows_by_algo.items()):
        s = choose_num_shards(rows)
        if s is None:
            continue
        entry = {"num_shards": s}
        if chunk is not None:
            entry["chunk"] = chunk
        chosen[algo] = entry
        curves[algo] = [
            {
                "num_shards": int(r["num_shards"]),
                "stream_seconds": float(r["stream_seconds"]),
                "boundary_conflicts": int(r.get("boundary_conflicts", 0)),
            }
            for r in rows
            if isinstance(r.get("stream_seconds"), (int, float))
            and int(r.get("num_shards", 0)) >= 1
        ]
    if chosen:
        # default = the *smallest* knee across algorithms: under-sharding
        # costs latency, over-sharding costs quality (conflicts)
        entry = {"num_shards": int(min(e["num_shards"] for e in chosen.values()))}
        if chunk is not None:
            entry["chunk"] = chunk
        chosen["default"] = entry
    return {"version": 1, "latency_slack": _LATENCY_SLACK, "chosen": chosen, "curves": curves}


def _candidate_paths(path: str | os.PathLike | None) -> list[Path]:
    if path is not None:
        return [Path(path)]
    out = []
    env = os.environ.get(ENV_PATH)
    if env:
        out.append(Path(env))
    out.append(Path.cwd() / DEFAULT_FILENAME)
    # src/repro_torch/core/autotune.py -> repo root is parents[3]
    out.append(Path(__file__).resolve().parents[3] / DEFAULT_FILENAME)
    return out


def load_artifact(path: str | os.PathLike | None = None) -> tuple[dict, Path] | None:
    """First readable tuning artifact along the search path, or None."""
    for p in _candidate_paths(path):
        try:
            with open(p) as fh:
                art = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(art, dict) and isinstance(art.get("chosen"), dict):
            return art, p
    return None


def _heuristic_num_shards(num_vertices: int | None) -> int:
    s = max(2, min(8, os.cpu_count() or 1))
    if num_vertices is not None:
        # a shard should see at least a few chunks' worth of stream, else
        # superstep overhead dominates; tiny graphs fall back to sequential
        s = max(1, min(s, int(num_vertices) // 2048))
    return s


def resolve(
    num_shards: int,
    chunk: int,
    *,
    algo: str,
    num_vertices: int | None = None,
    path: str | os.PathLike | None = None,
) -> Tuning:
    """Resolve possibly-auto (``0``) parallel knobs to concrete values.

    Explicit values pass through untouched (source ``explicit``). Auto
    values come from the tuning artifact's ``chosen[algo]`` (falling back to
    ``chosen["default"]``), else from the CPU-count heuristic.
    """
    num_shards = int(num_shards)
    chunk = int(chunk)
    if num_shards < 0:
        raise ValueError(f"num_shards must be >= 1, or 0/'auto', got {num_shards!r}")
    if chunk < 0:
        raise ValueError(f"chunk must be >= 1, or 0 for auto, got {chunk!r}")
    if num_shards >= 1 and chunk >= 1:
        return Tuning(num_shards, chunk, "explicit")
    loaded = load_artifact(path)
    entry = None
    source = "heuristic"
    if loaded is not None:
        art, p = loaded
        entry = art["chosen"].get(algo) or art["chosen"].get("default")
        if entry is not None:
            source = f"artifact:{p}"
    if num_shards == 0:
        if entry is not None:
            num_shards = int(entry["num_shards"])
        else:
            num_shards = _heuristic_num_shards(num_vertices)
    if chunk == 0:
        if entry is not None and int(entry.get("chunk", 0)) >= 1:
            chunk = int(entry["chunk"])
        else:
            chunk = 512
    return Tuning(num_shards, chunk, source)
