"""CI smoke for the partition-aware serving layer, on the PyTorch port.

Runs a short closed-loop load-gen burst through :mod:`repro_torch.serve.graph`
on an R-MAT graph partitioned by the port and asserts the figure-level
ordering on deterministic sim metrics (message-flow-derived,
bit-reproducible across hosts):

* cuttana's measured throughput (``qps_sim``) must exceed random's;
* cuttana's p99 sim latency must be <= random's;
* ``replication_budget > 0`` must reduce cross-partition RPCs with
  byte-identical answers;
* rerunning the same load must reproduce the exact same sim metrics.

Writes the full ``ServingReport`` dicts to ``--out``. Needs >= 2 cores for
the threaded router to be a real concurrency test; on a single-core runner
it exits 0 with an explicit skip reason. ``run(args)`` does the work and
returns the report (with each check's outcome); ``gates`` applies them.

    PYTHONPATH=src python scripts/torch/serving_smoke.py --out serving_report.json               # on a CUDA card
    PYTHONPATH=src python scripts/torch/serving_smoke.py --out serving_report.json --device cpu  # plain PyTorch versions
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
    ap.add_argument("--n", type=int, default=6_000)
    ap.add_argument("--avg-degree", type=int, default=12)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--queries", type=int, default=800)
    ap.add_argument("--concurrency", type=int, default=256)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--replication-budget", type=float, default=0.05)
    ap.add_argument("--out", default="serving_report.json")
    ap.add_argument("--device", default="cuda")
    return ap


def spec(algo: str, k: int, seed: int):
    """The serving benchmark's spec of ``algo``."""
    from repro_torch.api import PartitionSpec

    if algo in ("random", "hdrf"):
        return PartitionSpec(algo=algo, k=k, seed=seed)
    return PartitionSpec(
        algo=algo, k=k, balance_mode="edge", order="random", seed=seed
    )


def run(args) -> dict:
    from repro_torch.api import partition
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.serve.graph import QueryMix, build_workload, run_load

    graph = rmat_graph(args.n, avg_degree=args.avg_degree, seed=args.seed)
    workload = build_workload(
        graph, args.queries, QueryMix(), seed=args.seed + 1
    )
    report: dict = {
        "cores": os.cpu_count() or 1, "n": args.n, "k": args.k,
        "queries": args.queries, "concurrency": args.concurrency,
    }

    reps = {}
    for algo in ("cuttana", "random"):
        result = partition(graph, spec(algo, args.k, args.seed), device=args.device)
        reps[algo] = run_load(
            result.serve(store_results=False),
            workload=workload, concurrency=args.concurrency,
        )
        report[algo] = reps[algo].to_dict()
    c, r = reps["cuttana"], reps["random"]
    report["_checks"] = {
        "qps": (c.qps_sim, r.qps_sim, c.qps_sim > r.qps_sim),
        "p99": (c.latency_ms["sim"]["p99"], r.latency_ms["sim"]["p99"],
                c.latency_ms["sim"]["p99"] <= r.latency_ms["sim"]["p99"]),
    }

    # replication must cut RPCs without changing a single answer
    result = partition(graph, spec("cuttana", args.k, args.seed), device=args.device)
    sub = workload[: min(args.queries, 300)]
    base = run_load(result.serve(replication_budget=0.0),
                    workload=sub, concurrency=args.concurrency)
    repl = run_load(result.serve(replication_budget=args.replication_budget),
                    workload=sub, concurrency=args.concurrency)
    parity = all(
        np.array_equal(va, vb) if isinstance(va, np.ndarray) else va == vb
        for (va, vb) in (
            (base.answers()[qid], repl.answers()[qid])
            for qid in base.answers()
        )
    )
    report["_checks"]["replication"] = (base.rpcs, repl.rpcs, parity,
                                        repl.rpcs < base.rpcs and parity)
    report["replication"] = {
        "budget": args.replication_budget,
        "rpcs_base": base.rpcs, "rpcs_replicated": repl.rpcs,
        "answers_identical": bool(parity), **repl.replication,
    }

    # determinism: a rerun must reproduce the sim metrics bit-for-bit
    rerun = run_load(result.serve(replication_budget=0.0),
                     workload=sub, concurrency=args.concurrency)
    report["_checks"]["determinism"] = (
        rerun.qps_sim == base.qps_sim
        and rerun.rpcs == base.rpcs
        and rerun.wire_bytes == base.wire_bytes
        and rerun.latency_ms["sim"] == base.latency_ms["sim"]
    )
    return report


def gates(report: dict, args) -> list[str]:
    """Print each check's status line; return the checks that failed."""
    checks = report["_checks"]
    failures: list[str] = []
    c_qps, r_qps, qps_ok = checks["qps"]
    p99_c, p99_r, p99_ok = checks["p99"]
    print(
        f"{'OK' if qps_ok else 'FAIL'}: qps_sim cuttana {c_qps:.0f} vs "
        f"random {r_qps:.0f} (ratio {c_qps / r_qps:.2f})"
    )
    print(
        f"{'OK' if p99_ok else 'FAIL'}: p99_sim cuttana {p99_c:.4f}ms vs "
        f"random {p99_r:.4f}ms"
    )
    if not qps_ok:
        failures.append("cuttana qps_sim <= random qps_sim")
    if not p99_ok:
        failures.append("cuttana p99_sim > random p99_sim")
    rpcs_base, rpcs_repl, parity, repl_ok = checks["replication"]
    print(
        f"{'OK' if repl_ok else 'FAIL'}: replication rpcs {rpcs_base} -> "
        f"{rpcs_repl} (parity={parity})"
    )
    if not repl_ok:
        failures.append("replication did not cut RPCs at fixed answers")
    det_ok = checks["determinism"]
    print(f"{'OK' if det_ok else 'FAIL'}: sim metrics reproduce exactly")
    if not det_ok:
        failures.append("sim metrics not deterministic across reruns")
    return failures


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cores = os.cpu_count() or 1
    if cores < 2:
        print(
            f"SKIP: serving smoke needs >= 2 cores, runner has {cores}; "
            "concurrent router throughput is not a real test here"
        )
        with open(args.out, "w") as fh:
            json.dump({"skipped": f"{cores} core(s)"}, fh, indent=2)
        return 0

    report = run(args)
    failures = gates(report, args)
    with open(args.out, "w") as fh:
        json.dump({key: v for key, v in report.items() if not key.startswith("_")}, fh,
                  indent=2, default=str)
    print(f"wrote {args.out}")
    if failures:
        print(f"FAILED: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
