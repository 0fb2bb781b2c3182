"""CI smoke for the compressed out-of-core CSR v2 + prefetch pipeline, on
the PyTorch port.

Generates a ~1M-edge R-MAT, dumps its edge list, converts it twice (v1 raw
and v2 block-compressed, parallel workers) with the port's converter, and
asserts on the runner itself:

1. **compression** - the v2 file must be < ``--max-file-ratio`` (default
   0.7) of the v1 file;
2. **parity** - the v2 mapped partition (``cuttana-parallel``, S=4) is
   bit-identical to the fully resident run;
3. **overlap** - with >= 2 cores, the prefetch-on mapped stream must take at
   most ``--prefetch-ratio`` (default 0.9) of the prefetch-off (synchronous)
   mapped stream. On a single-core runner this check skips itself with an
   explicit reason.

Writes a machine-readable report (convert stats, both stream walls, the
prefetch telemetry and per-superstep profile) to ``--out``. ``run(args)``
does the work and returns the report; ``gates`` applies the bounds
(``timing=False`` leaves out the host-timing one).

    PYTHONPATH=src python scripts/torch/outofcore_smoke.py --out outofcore_smoke.json               # on a CUDA card
    PYTHONPATH=src python scripts/torch/outofcore_smoke.py --out outofcore_smoke.json --device cpu  # plain PyTorch versions
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65_000)
    ap.add_argument("--avg-degree", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument("--max-file-ratio", type=float, default=0.7,
                    help="required v2/v1 on-disk size bound")
    ap.add_argument("--prefetch-ratio", type=float, default=0.9,
                    help="required prefetch-on/prefetch-off stream bound "
                         "(needs >= 2 cores)")
    ap.add_argument("--out", default="outofcore_smoke.json")
    ap.add_argument("--device", default="cuda")
    return ap


def stream_seconds(res) -> float:
    t = res.timings
    return t.get("phase1_seconds", t.get("stream_seconds", t["total_s"]))


def run(args) -> dict:
    import numpy as np

    from repro_torch.api import PartitionSpec, partition
    from repro_torch.graph.external import ExternalCSRGraph, convert_edge_list
    from repro_torch.graph.generators import rmat_graph

    graph = rmat_graph(args.n, avg_degree=args.avg_degree, seed=3)
    report: dict = {
        "cores": os.cpu_count() or 1, "n": args.n, "num_edges": int(graph.num_edges),
        "num_shards": args.num_shards,
    }
    with tempfile.TemporaryDirectory() as td:
        edges = os.path.join(td, "edges.npy")
        np.save(edges, graph.edges_array())
        print(f"graph: |V|={graph.num_vertices} |E|={graph.num_edges} "
              f"({2 * graph.num_edges} half-edges)")

        # ---- conversion: v1 raw vs v2 compressed (parallel workers)
        paths = {}
        for ver in (1, 2):
            out = os.path.join(td, f"graph.v{ver}.bin")
            t0 = time.perf_counter()
            stats = convert_edge_list(
                edges, out, num_vertices=args.n, format_version=ver,
            )
            stats["convert_seconds"] = round(time.perf_counter() - t0, 3)
            report[f"v{ver}"] = stats
            paths[ver] = out
            print(f"v{ver}: {stats['file_bytes']} bytes in "
                  f"{stats['convert_seconds']}s ({stats['workers']} workers)")
        file_ratio = report["v2"]["file_bytes"] / report["v1"]["file_bytes"]
        report["file_ratio"] = round(file_ratio, 4)
        report["_file_ratio"] = file_ratio

        # ---- parity + prefetch overlap on the sharded engine
        ext = ExternalCSRGraph(paths[2])

        def run_one(g, prefetch):
            spec = PartitionSpec(
                algo="cuttana-parallel", k=args.k, balance_mode="edge",
                order="random", seed=3,
                params={"num_shards": args.num_shards, "prefetch": prefetch},
            )
            return partition(g, spec, device=args.device)

        resident = run_one(graph, "auto")
        mapped_on = run_one(ext, "on")
        mapped_off = run_one(ext, "off")
        report["_parity"] = {
            name: bool(np.array_equal(resident.assignment, res.assignment))
            for name, res in (("mapped-on", mapped_on), ("mapped-off", mapped_off))}

        on_s, off_s = stream_seconds(mapped_on), stream_seconds(mapped_off)
        report["stream"] = {
            "prefetch_on_s": on_s,
            "prefetch_off_s": off_s,
            "ratio": round(on_s / max(off_s, 1e-12), 4),
            "prefetch_hit_rate": mapped_on.telemetry.get("prefetch_hit_rate"),
            "decode_wall_s": mapped_on.telemetry.get("decode_wall_s"),
            "profile": mapped_on.telemetry.get("profile"),
        }
        report["_prefetch_ratio"] = on_s / max(off_s, 1e-12)
    return report


def gates(report: dict, args, timing: bool = True) -> list[str]:
    """Print each bound's status line; return the checks that failed.
    ``timing=False`` leaves out the prefetch-overlap bound (host timing)."""
    failures: list[str] = []
    file_ratio = report["_file_ratio"]
    status = "OK" if file_ratio < args.max_file_ratio else "FAIL"
    print(f"{status}: v2/v1 file ratio {file_ratio:.3f} "
          f"(bound {args.max_file_ratio})")
    if file_ratio >= args.max_file_ratio:
        failures.append("compression")
    for name, same in report["_parity"].items():
        if not same:
            print(f"FAIL: {name} assignments differ from resident")
            failures.append(f"parity:{name}")
    if not any(f.startswith("parity") for f in failures):
        print("OK: mapped assignments bit-identical to resident "
              "(prefetch on and off)")
    if not timing:
        return failures
    cores = report["cores"]
    if cores < 2:
        report["stream"]["skipped"] = (
            f"prefetch-overlap bound needs >= 2 cores, runner has {cores}"
        )
        print(f"SKIP: {report['stream']['skipped']} "
              f"(measured ratio {report['stream']['ratio']:.2f})")
    else:
        ratio = report["_prefetch_ratio"]
        status = "OK" if ratio <= args.prefetch_ratio else "FAIL"
        print(f"{status}: prefetch-on {report['stream']['prefetch_on_s']:.3f}s vs off "
              f"{report['stream']['prefetch_off_s']:.3f}s "
              f"(ratio {ratio:.2f}, bound {args.prefetch_ratio})")
        if ratio > args.prefetch_ratio:
            failures.append("prefetch-overlap")
    return failures


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    report = run(args)
    failures = gates(report, args)
    with open(args.out, "w") as fh:
        json.dump({key: v for key, v in report.items() if not key.startswith("_")}, fh, indent=2)
    print(f"wrote {args.out}")
    if failures:
        print(f"FAILED: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
