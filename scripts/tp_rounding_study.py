"""Is a tensor-parallel run's parameter gap float32's or the split's?

Reduced jamba-v0.1-52b takes 3 steps of ``launch.train`` (B=4, T=16) on
the CPU three ways: on one device in float32, on a 1x2 mesh in float32
(two gloo ranks: the model axis splits the products), and on one device in
float64 from the same parameters (``tests/mesh_tolerance.py``'s
``float64_program``). For the parameters the 1x2 run misses the float32
one by most, it prints the relative L2 gaps between each pair and how many
entries float32 does not resolve (``mesh_tolerance.unresolved``). Where
both float32 runs stand as far from the float64 run as from each other,
the gap is float32's rounding, not a fault of the split.

    PYTHONPATH=src python scripts/tp_rounding_study.py [--arch reduced:...] [--top 8]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))

from mesh_tolerance import float64_program, unresolved  # noqa: E402

from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402

TRAIN = ["--steps", "3", "--global-batch", "4", "--seq-len", "16", "--log-every", "100",
         "--device", "cpu"]
RTOL = 1e-5


def _rank(rank: int, world: int, store: str, arch: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    try:
        train_mod.main(["--arch", arch, *TRAIN, "--dtype", "float32", "--mesh", "1x2",
                        "--ckpt-dir", out], [])
    finally:
        dist.destroy_process_group()


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _params(arch: str, directory: str) -> list:
    cfg = dataclasses.replace(train_mod.get_model_config(arch), dtype="float32")
    shapes = Model(cfg, "cpu").init_shapes()
    like = train_mod.checkpoint_tree(cfg, shapes, adamw_init(shapes))
    return list(_paths(ckpt.restore_checkpoint(directory, like)[0][0]))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="reduced:jamba-v0.1-52b")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="tp_rounding_") as work:
        tp = os.path.join(work, "f32_1x2")
        torch.multiprocessing.start_processes(
            _rank, args=(2, f"file://{work}/store", args.arch, tp), nprocs=2, join=True,
            start_method="spawn")
        one = os.path.join(work, "f32_1x1")
        train_mod.main(["--arch", args.arch, *TRAIN, "--dtype", "float32", "--ckpt-dir", one], [])
        f64 = os.path.join(work, "f64_1x1")
        with float64_program():
            train_mod.main(["--arch", args.arch, *TRAIN, "--dtype", "float64", "--ckpt-dir", f64],
                           [], overrides={"opt_state_dtype": "float64"})
        rows = []
        for (name, a), (_, b), (_, c) in zip(_params(args.arch, tp), _params(args.arch, one),
                                             _params(args.arch, f64)):
            rows.append((_rel(a, b), name, _rel(a, c), _rel(b, c),
                         int(unresolved(b, c, RTOL).sum()), b.numel()))
    rows.sort(reverse=True)
    print("1x2 vs 1x1 f32 | 1x2 vs f64 | 1x1 f32 vs f64 | unresolved entries | parameter")
    for gap, name, tp64, one64, loose, n in rows[:args.top]:
        print(f"{gap:.3e} | {tp64:.3e} | {one64:.3e} | {loose}/{n} | {name}")


if __name__ == "__main__":
    main()
