"""CI smoke for incremental repartitioning under churn, on the PyTorch port.

Replays a seeded ~200k-edge synthetic churn stream (random arrival ordering,
the adversarial case) through the port's incremental partitioner and asserts
the acceptance bar against a full re-partition of the same stream:

* quality: incremental final edge-cut <= ``--cut-ratio`` (default 1.15) x
  the full re-partition edge-cut;
* cost: incremental stream work (vertex placements: arrivals + re-stream
  windows + isolated finalization) <= ``--work-ratio`` (default 0.5) x the
  full strategy's cumulative work (every seen vertex re-streamed at every
  batch).

Both sides are deterministic and seeded, so the bound is stable across
runners. Needs >= 2 cores so the smoke can't crowd out other jobs on a
single-core runner; there it exits 0 with an explicit skip reason
(``--force`` overrides, for local runs). Writes ``churn_report.json`` either
way. ``run(args)`` does the work and returns the report; ``gates`` applies
the bounds.

    PYTHONPATH=src python scripts/torch/churn_smoke.py --out churn_report.json               # on a CUDA card
    PYTHONPATH=src python scripts/torch/churn_smoke.py --out churn_report.json --device cpu  # plain PyTorch versions
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=25_000)
    ap.add_argument("--avg-degree", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--num-batches", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cut-ratio", type=float, default=1.15,
                    help="required incremental/full edge-cut bound")
    ap.add_argument("--work-ratio", type=float, default=0.5,
                    help="required incremental/full stream-work bound")
    ap.add_argument("--force", action="store_true",
                    help="run even on a single-core machine")
    ap.add_argument("--out", default="churn_report.json")
    ap.add_argument("--device", default="cuda")
    return ap


def full_repartition_work(stream, num_batches: int) -> int:
    """Cumulative stream work of re-partitioning from scratch at every
    batch: sum over batches of the vertices seen so far."""
    seen = np.zeros(stream.num_vertices, dtype=bool)
    total = 0
    for batch in stream.batches(num_batches):
        if batch.size:
            seen[np.unique(batch)] = True
        total += int(seen.sum())
    return total


def run(args) -> dict:
    from repro_torch.core import fennel
    from repro_torch.core.incremental import update
    from repro_torch.graph.churn import rmat_churn
    from repro_torch.graph.metrics import edge_cut

    stream = rmat_churn(
        args.n, avg_degree=args.avg_degree, seed=args.seed, ordering="random"
    )
    graph = stream.final_graph()
    print(
        f"stream: |V|={stream.num_vertices} m={stream.num_edges} "
        f"k={args.k} batches={args.num_batches}"
    )

    # incremental replay through the public update() API (cold start)
    result = update(
        None, stream, k=args.k, balance_mode="edge", seed=args.seed,
        num_batches=args.num_batches, device=args.device,
    )
    cut_inc = edge_cut(graph, result.assignment, device=args.device)
    work_inc = result.telemetry["stream_work"]

    # full re-partition on the final snapshot (quality target) + its
    # cumulative per-batch work (cost target)
    part_full = fennel.partition(
        graph, args.k, balance_mode="edge", seed=args.seed, device=args.device
    )
    cut_full = edge_cut(graph, part_full, device=args.device)
    work_full = full_repartition_work(stream, args.num_batches)

    cut_ratio = cut_inc / max(cut_full, 1e-12)
    work_ratio = work_inc / max(work_full, 1)
    return {
        "cores": os.cpu_count() or 1,
        "n": stream.num_vertices,
        "m": stream.num_edges,
        "k": args.k,
        "num_batches": args.num_batches,
        "edge_cut_incremental": float(cut_inc),
        "edge_cut_full": float(cut_full),
        "cut_ratio": float(cut_ratio),
        "cut_ratio_bound": args.cut_ratio,
        "stream_work_incremental": int(work_inc),
        "stream_work_full": int(work_full),
        "work_ratio": float(work_ratio),
        "work_ratio_bound": args.work_ratio,
        "restream_windows": result.telemetry["restream_windows"],
        "moved_vertices": result.telemetry["moved_vertices"],
        "drift_before": result.telemetry["drift_before"],
        "drift_after": result.telemetry["drift_after"],
        "update_seconds": result.timings["stream_seconds"],
    }


def gates(report: dict, args) -> list[str]:
    """Print each bound's status line; return the names of those exceeded."""
    failures = []
    cut_ratio, work_ratio = report["cut_ratio"], report["work_ratio"]
    status = "OK" if cut_ratio <= args.cut_ratio else "FAIL"
    print(
        f"{status}: edge-cut {report['edge_cut_incremental']:.4f} vs full "
        f"{report['edge_cut_full']:.4f} "
        f"(ratio {cut_ratio:.3f}, bound {args.cut_ratio})"
    )
    if cut_ratio > args.cut_ratio:
        failures.append("cut_ratio")
    status = "OK" if work_ratio <= args.work_ratio else "FAIL"
    print(
        f"{status}: stream work {report['stream_work_incremental']} vs full "
        f"{report['stream_work_full']} "
        f"(ratio {work_ratio:.3f}, bound {args.work_ratio}, "
        f"{report['restream_windows']} re-stream windows, "
        f"{report['moved_vertices']} moved)"
    )
    if work_ratio > args.work_ratio:
        failures.append("work_ratio")
    return failures


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cores = os.cpu_count() or 1
    if cores < 2 and not args.force:
        print(
            f"SKIP: churn smoke needs >= 2 cores, runner has {cores}; "
            "the churn suite still gates quality via the bench trajectory"
        )
        with open(args.out, "w") as fh:
            json.dump({"skipped": f"{cores} core(s)"}, fh, indent=2)
        return 0

    report = run(args)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2)
    print(f"wrote {args.out}")
    failures = gates(report, args)
    if failures:
        print(f"FAILED: {failures} exceeded their bounds")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
