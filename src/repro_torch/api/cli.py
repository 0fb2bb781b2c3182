"""Headless spec runner of the port (``repro.api.cli``'s commands, flags
and defaults, plus ``--device``):

    python -m repro_torch.api.cli partition --spec spec.json --out report.json \\
        [--dataset social-s | --rmat 20000 | --graph graph.bin] \\
        [--with-analytics] [--with-db] [--device cuda|cpu]
    python -m repro_torch.api.cli serve-bench --spec spec.json --rmat 20000 \\
        --queries 5000 --concurrency 1000 [--replication-budget 0.05]
    python -m repro_torch.api.cli update --spec spec.json --churn stream.npz \\
        [--prior-graph g.npz --prior-assignment part.npy]
    python -m repro_torch.api.cli list

``partition`` loads a :class:`~repro_torch.api.spec.PartitionSpec` from
JSON, runs it on the requested graph (a named benchmark dataset, a seeded
R-MAT, or an on-disk graph file partitioned out-of-core via ``--graph`` -
convert an edge list with ``python -m repro_torch.launch.convert_graph``
first; the spec's own ``source`` field is used when no graph flag is
given), and emits a structured report (spec, timings, telemetry, quality
metrics, and optionally the analytics cost model / DB workload numbers).
``serve-bench`` additionally stands up the partition-aware serving layer
(:mod:`repro_torch.serve.graph`) and drives a concurrent mixed query load
through it, reporting throughput, p50/p95/p99 latency, and RPC/byte counts
from the router's real message flow. ``update`` replays a saved
:class:`~repro_torch.graph.churn.ChurnStream` through the incremental
partitioner (:mod:`repro_torch.core.incremental`), optionally
warm-starting from a prior snapshot + assignment, and reports the churn
telemetry (batches, re-stream windows, moved vertices, drift trajectory).
``list`` prints the declarative registry.

``--device`` (``partition``, ``serve-bench``, ``update``; default ``cuda``)
is where the partition is made: on the card the partition-score kernel
scores the stream; ``cpu`` takes the plain versions. Without a card a
``cuda`` run exits non-zero with the runner's error; it never carries on
with the CPU. The DB study and the serving layer run on the host. ``list``
needs no device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where the partition is made: cuda (the "
                             "default; needs a card) or cpu")


def _device(args):
    """``args.device`` resolved before any graph is loaded: a request for a
    missing card ends the command with the runner's error."""
    from repro_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as err:
        raise SystemExit(f"{args.cmd}: {err}") from err


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("partition", help="run a PartitionSpec JSON headlessly")
    p.add_argument("--spec", required=True, help="path to a PartitionSpec JSON file")
    p.add_argument("--out", default=None,
                   help="write the JSON report here (default: stdout)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--dataset", default=None,
                   help="named benchmark dataset (e.g. social-s, ldbc-s)")
    g.add_argument("--rmat", type=int, default=None, metavar="N",
                   help="generate an N-vertex R-MAT graph instead")
    g.add_argument("--graph", default=None, metavar="PATH",
                   help="partition an on-disk graph file: a .bin external "
                        "CSR (memory-mapped, out-of-core) or a .npz "
                        "CSRGraph dump")
    p.add_argument("--avg-degree", type=float, default=16.0,
                   help="R-MAT average degree (with --rmat)")
    p.add_argument("--graph-seed", type=int, default=0,
                   help="generator seed for --dataset/--rmat")
    p.add_argument("--assignment-out", default=None,
                   help="also save the raw assignment as .npy")
    p.add_argument("--prefetch", choices=("auto", "on", "off"), default=None,
                   help="override the spec's out-of-core decode-ahead mode "
                        "(auto = only for memory-mapped graphs); never "
                        "changes assignments")
    p.add_argument("--skip-quality", action="store_true",
                   help="omit quality metrics from the report (they scan "
                        "the whole edge set - skip for graphs that "
                        "deliberately exceed RAM)")
    p.add_argument("--with-analytics", action="store_true",
                   help="include the analytics cost model in the report")
    p.add_argument("--analytics-iters", type=int, default=30)
    p.add_argument("--with-db", action="store_true",
                   help="include the DB workload study in the report")
    p.add_argument("--db-queries", type=int, default=256)
    _add_device(p)

    s = sub.add_parser(
        "serve-bench",
        help="partition, stand up the serving layer, drive a query load",
    )
    s.add_argument("--spec", required=True, help="path to a PartitionSpec JSON file")
    s.add_argument("--out", default=None,
                   help="write the JSON report here (default: stdout)")
    g = s.add_mutually_exclusive_group()
    g.add_argument("--dataset", default=None,
                   help="named benchmark dataset (e.g. social-s, ldbc-s)")
    g.add_argument("--rmat", type=int, default=None, metavar="N",
                   help="generate an N-vertex R-MAT graph instead")
    g.add_argument("--graph", default=None, metavar="PATH",
                   help="serve an on-disk graph file (.bin external CSR or "
                        ".npz CSRGraph dump)")
    s.add_argument("--avg-degree", type=float, default=16.0,
                   help="R-MAT average degree (with --rmat)")
    s.add_argument("--graph-seed", type=int, default=0,
                   help="generator seed for --dataset/--rmat")
    s.add_argument("--queries", type=int, default=1000,
                   help="number of queries in the load run")
    s.add_argument("--concurrency", type=int, default=256,
                   help="closed-loop in-flight query slots")
    s.add_argument("--mix", default=None, metavar="SPEC",
                   help='query mix, e.g. "point=0.2,one_hop=0.4,two_hop=0.4"')
    s.add_argument("--mode", choices=("closed", "open"), default="closed",
                   help="arrival discipline of the load generator")
    s.add_argument("--rate", type=float, default=None, metavar="QPS",
                   help="open-loop arrival rate (with --mode open)")
    s.add_argument("--load-seed", type=int, default=0,
                   help="workload generator seed")
    s.add_argument("--replication-budget", type=float, default=None,
                   help="override the spec's boundary-replication budget")
    s.add_argument("--max-workers", type=int, default=0,
                   help="serving worker threads (0 = auto, one per "
                        "partition up to cpu_count)")
    _add_device(s)

    u = sub.add_parser(
        "update",
        help="incrementally update a prior partition with edge-arrival "
             "batches (algo must be cuttana-incremental)",
    )
    u.add_argument("--spec", required=True,
                   help="path to a cuttana-incremental PartitionSpec JSON")
    u.add_argument("--churn", required=True, metavar="PATH",
                   help="ChurnStream .npz (repro_torch.graph.churn) to replay")
    u.add_argument("--prior-graph", default=None, metavar="PATH",
                   help=".npz CSRGraph snapshot to warm-start from "
                        "(cold start when omitted)")
    u.add_argument("--prior-assignment", default=None, metavar="PATH",
                   help=".npy prior assignment (requires --prior-graph)")
    u.add_argument("--num-batches", type=int, default=None,
                   help="override the spec's replay batch count")
    u.add_argument("--out", default=None,
                   help="write the JSON report here (default: stdout)")
    u.add_argument("--assignment-out", default=None,
                   help="also save the updated assignment as .npy")
    _add_device(u)

    sub.add_parser("list", help="list the partitioner registry")
    return ap


def _load_graph(args, spec):
    if args.graph is not None:
        # file-only, as the help text promises: generator sources belong in
        # the spec's own `source` field
        from repro_torch.graph.external import load_graph_file

        return load_graph_file(args.graph), args.graph
    if args.rmat is not None:
        from repro_torch.graph.generators import rmat_graph

        return rmat_graph(
            args.rmat, avg_degree=args.avg_degree, seed=args.graph_seed
        ), f"rmat:{args.rmat}"
    if args.dataset is None and spec.source is not None:
        # no graph flags: fall back to the spec's own source, resolved with
        # spec.seed exactly like repro_torch.api.partition(spec) - the same spec
        # JSON must mean the same graph through either entry point
        from repro_torch.graph.external import load_graph_source

        return load_graph_source(spec.source, seed=spec.seed), spec.source
    from repro_torch.graph.generators import DATASETS, load_dataset

    name = args.dataset or "social-s"
    if name not in DATASETS:
        raise SystemExit(
            f"unknown dataset {name!r}; available: {', '.join(sorted(DATASETS))}"
        )
    return load_dataset(name, seed=args.graph_seed), name


def _cmd_partition(args) -> int:
    import dataclasses

    from repro_torch.api import PartitionSpec, partition

    spec_text = Path(args.spec).read_text()
    spec = PartitionSpec.from_json(spec_text)
    if args.prefetch is not None:
        params = spec.params
        fields = (
            {f.name for f in dataclasses.fields(params)}
            if params is not None
            else set()
        )
        if "prefetch" not in fields:
            raise SystemExit(
                f"{spec.algo!r} does not accept a prefetch knob"
            )
        spec = spec.replace(
            params=dataclasses.replace(params, prefetch=args.prefetch)
        )
    device = _device(args)
    graph, graph_name = _load_graph(args, spec)
    result = partition(graph, spec, device=device)
    report = result.to_report(include_quality=not args.skip_quality)
    report["graph"]["name"] = graph_name
    if args.with_analytics:
        report["analytics"] = result.analytics(
            iters=args.analytics_iters, mode="model"
        )
    if args.with_db:
        report["db"] = {
            "one_hop": result.db(hops=1, num_queries=args.db_queries),
            "two_hop": result.db(hops=2, num_queries=args.db_queries),
        }
    if args.assignment_out:
        import numpy as np

        # np.save appends .npy when missing; record the path it actually used
        path = args.assignment_out
        if not path.endswith(".npy"):
            path += ".npy"
        np.save(path, result.assignment)
        report["assignment_path"] = path
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


def _cmd_update(args) -> int:
    import dataclasses

    import numpy as np

    from repro_torch.api import PartitionSpec
    from repro_torch.core.incremental import update
    from repro_torch.graph.churn import ChurnStream
    from repro_torch.graph.csr import CSRGraph

    spec = PartitionSpec.from_json(Path(args.spec).read_text())
    if spec.algo != "cuttana-incremental":
        raise SystemExit(
            f"update needs a cuttana-incremental spec, got {spec.algo!r}"
        )
    device = _device(args)
    stream = ChurnStream.load(args.churn)
    prior = None
    if args.prior_assignment is not None and args.prior_graph is None:
        raise SystemExit("--prior-assignment requires --prior-graph")
    if args.prior_graph is not None:
        if args.prior_assignment is None:
            raise SystemExit("--prior-graph requires --prior-assignment")
        prior = (
            CSRGraph.load(args.prior_graph),
            np.load(args.prior_assignment),
        )
    knobs = dataclasses.asdict(spec.params)
    if args.num_batches is not None:
        knobs["num_batches"] = args.num_batches
    result = update(
        prior,
        stream,
        k=spec.k,
        epsilon=spec.epsilon,
        balance_mode=spec.balance_mode,
        seed=spec.seed,
        device=device,
        **knobs,
    )
    report = result.to_report()
    report["graph"]["name"] = args.churn
    report["churn"] = {
        "num_edges": stream.num_edges,
        "num_vertices": stream.num_vertices,
        "warm_start": prior is not None,
    }
    if args.assignment_out:
        path = args.assignment_out
        if not path.endswith(".npy"):
            path += ".npy"
        np.save(path, result.assignment)
        report["assignment_path"] = path
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


def _cmd_list() -> int:
    from repro_torch.api import REGISTRY

    header = f"{'name':<24}{'kind':<12}{'placement':<11}{'engine':<8}{'balance':<14}params"
    print(header)
    print("-" * len(header))
    for name in sorted(REGISTRY):
        info = REGISTRY[name]
        balance = ",".join(info.balance_modes) or "-"
        params = ",".join(info.param_names()) or "-"
        print(
            f"{name:<24}{info.kind:<12}{info.placement:<11}"
            f"{info.engine:<8}{balance:<14}{params}"
        )
    return 0


def _cmd_serve_bench(args) -> int:
    from repro_torch.api import PartitionSpec, partition

    spec = PartitionSpec.from_json(Path(args.spec).read_text())
    device = _device(args)
    graph, graph_name = _load_graph(args, spec)
    result = partition(graph, spec, device=device)
    report = {
        "spec": spec.to_dict(),
        "graph": {
            "name": graph_name,
            "num_vertices": int(graph.num_vertices),
            "num_edges": int(graph.num_edges),
        },
        "serving": result.serve_bench(
            num_queries=args.queries,
            concurrency=args.concurrency,
            mix=args.mix,
            seed=args.load_seed,
            mode=args.mode,
            rate_qps=args.rate,
            replication_budget=args.replication_budget,
            max_workers=args.max_workers,
        ),
    }
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "list":
        return _cmd_list()
    if args.cmd == "serve-bench":
        return _cmd_serve_bench(args)
    if args.cmd == "update":
        return _cmd_update(args)
    return _cmd_partition(args)


if __name__ == "__main__":
    raise SystemExit(main())
