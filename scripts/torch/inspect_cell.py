"""Hill-climb profiler of one dry-run cell (the port's counterpart of
``scripts/inspect_cell.py``): run the cell's step once on the fake process
group and print its dominant collectives (bytes x count, op, result shape
and the line of the port that called it) and its dot groups (FLOPs x calls
by op and input shapes).

    PYTHONPATH=src python scripts/torch/inspect_cell.py --arch deepseek-coder-33b \\
        --shape train_4k [--multi-pod] [--top 15]

The reference reads its loop multipliers out of the compiled HLO; the port
counts what runs, so "xN" is how many times one collective of that shape
ran from that line (a layer loop, a microbatch loop). Needs no card.
"""
from __future__ import annotations

import argparse
import collections
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "src"))


def inspect(arch: str, shape: str, multi_pod: bool, opt: str | None = None) -> dict:
    """The cell's collectives grouped by (op, bytes, shape, source) and its
    dots grouped by signature, from ``op_analysis.OpCounter``."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import OpCounter, analyze

    overrides = dryrun.parse_overrides(opt)
    # DTensor warns at every gather over two mesh dims; the counts are the point
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        counter = OpCounter(sources=True)
        with FakeTensorMode(), dryrun.shape_only_scan():
            step, args, mesh, meta = dryrun.lower_cell(arch, shape, multi_pod, overrides, mesh,
                                                       counter)
            h = analyze(step, *args, counter=counter)
    finally:
        dist.destroy_process_group()
    groups: dict = collections.defaultdict(int)
    for kind, nbytes, shapes, source, times in counter.records:
        groups[(kind, nbytes, str(shapes[0] if shapes else ()), source)] += times
    dots: dict = collections.defaultdict(int)
    for (op, shapes), n in counter.dots.items():
        dots[(op, str(shapes))] += n
    return {"summary": h, "accum": meta["accum"], "collectives": groups, "dots": dots}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--opt", default=None, help="config overrides, as the dry run's --opt")
    args = ap.parse_args(argv)

    from torch.utils.flop_counter import flop_registry  # noqa: F401  (import before the group)

    res = inspect(args.arch, args.shape, args.multi_pod, args.opt)
    items = sorted(((nbytes * n, nbytes, n, kind, shape, src)
                    for (kind, nbytes, shape, src), n in res["collectives"].items()), reverse=True)
    total = sum(i[0] for i in items)
    print(f"total collective bytes/shard/step: {total / 1e9:.2f} GB "
          f"({sum(i[2] for i in items)} collective ops, accum {res['accum']})")
    print(f"{'GB(total)':>10} {'MB(one)':>9} {'xN':>6}  op                shape/source")
    for tot, b, n, kind, shape, src in items[: args.top]:
        print(f"{tot / 1e9:>10.2f} {b / 1e6:>9.1f} {n:>6d}  {kind:<17} {shape[:40]}  <- {src}")
    print(f"\ndot FLOPs/shard/step: {res['summary']['dot_flops_per_shard'] / 1e12:.1f} TFLOP")
    print(f"{'calls':>6}  op        input shapes")
    for (op, shapes), n in sorted(res["dots"].items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"{n:>6d}  {op:<9} {shapes[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
