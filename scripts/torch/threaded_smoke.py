"""CI smoke for the threaded superstep engine, on the PyTorch port.

Asserts the headline perf claim on the runner itself: at S=4, the parallel
algorithms' streaming wall-clock must be at most ``--ratio`` (default 0.9)
of their sequential counterparts', for BOTH ``cuttana-parallel`` and
``fennel-parallel``. Writes the per-superstep profile of every parallel run
to ``--out`` as a machine-readable timing artifact. ``run(args)`` does the
runs and returns the report (the parallel assignments under
``"_assignments"``, which the file leaves out); ``gates`` applies the bound.

Needs >= 2 cores for the thread pool to mean anything; on a single-core
runner it exits 0 with an explicit skip reason.

    PYTHONPATH=src python scripts/torch/threaded_smoke.py --out threaded_profile.json               # on a CUDA card
    PYTHONPATH=src python scripts/torch/threaded_smoke.py --out threaded_profile.json --device cpu  # plain PyTorch versions
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

ALGOS = (("cuttana-parallel", "cuttana"), ("fennel-parallel", "fennel"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--avg-degree", type=int, default=12)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument("--ratio", type=float, default=0.9,
                    help="required parallel/sequential wall-clock bound")
    ap.add_argument("--out", default="threaded_profile.json")
    ap.add_argument("--device", default="cuda")
    return ap


def stream_seconds(result) -> float:
    # the paper's claim is about streaming latency; phase-2 refinement
    # is identical work on both sides and only dilutes the ratio
    t = result.timings
    return t.get("phase1_seconds", t.get("stream_seconds", t["total_s"]))


def specs(args, algo: str, base: str):
    """The sequential and the parallel spec of one pair."""
    from repro_torch.api import PartitionSpec

    return (PartitionSpec(algo=base, k=args.k, balance_mode="edge", order="random"),
            PartitionSpec(algo=algo, k=args.k, balance_mode="edge", order="random",
                          params={"num_shards": args.num_shards}))


def run(args) -> dict:
    from repro_torch.api import partition
    from repro_torch.graph.generators import rmat_graph

    graph = rmat_graph(args.n, avg_degree=args.avg_degree, seed=0)
    report: dict = {"cores": os.cpu_count() or 1, "n": args.n,
                    "num_shards": args.num_shards, "_assignments": {}}
    for algo, base in ALGOS:
        seq_spec, par_spec = specs(args, algo, base)
        seq_s = stream_seconds(partition(graph, seq_spec, device=args.device))
        res = partition(graph, par_spec, device=args.device)
        par_s = stream_seconds(res)
        report[algo] = {
            "sequential_s": seq_s,
            "parallel_s": par_s,
            "ratio": par_s / max(seq_s, 1e-12),
            "boundary_conflicts": res.telemetry.get("boundary_conflicts"),
            "max_workers": res.telemetry.get("max_workers"),
            "profile": res.profile,
        }
        report["_assignments"][algo] = res.assignment
    report["_graph"] = graph
    return report


def gates(report: dict, args) -> list[str]:
    """Print each algorithm's wall-clock status line; return those over the
    bound."""
    failures = []
    for algo, base in ALGOS:
        rec = report[algo]
        ratio = rec["ratio"]
        status = "OK" if ratio <= args.ratio else "FAIL"
        print(
            f"{status}: {algo} S={args.num_shards} {rec['parallel_s']:.3f}s vs "
            f"{base} {rec['sequential_s']:.3f}s (ratio {ratio:.2f}, bound {args.ratio})"
        )
        if ratio > args.ratio:
            failures.append(algo)
    return failures


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cores = os.cpu_count() or 1
    if cores < 2:
        print(
            f"SKIP: threaded smoke needs >= 2 cores, runner has {cores}; "
            "thread-pool speedup is not measurable here"
        )
        with open(args.out, "w") as fh:
            json.dump({"skipped": f"{cores} core(s)"}, fh, indent=2)
        return 0

    report = run(args)
    failures = gates(report, args)
    with open(args.out, "w") as fh:
        json.dump({key: v for key, v in report.items() if not key.startswith("_")}, fh, indent=2)
    print(f"wrote {args.out}")
    if failures:
        print(f"FAILED: {failures} exceeded the {args.ratio} wall-clock bound")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
