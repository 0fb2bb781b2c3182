"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (architecture x
input shape x mesh) cell at full width on the production meshes, with no
device memory, and the roofline inputs (per-shard dot FLOPs, collective
bytes, argument bytes) dumped as JSON.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k [--multi-pod] [--out runs/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8   # the 80 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \
        --opt activation_partitioning=seq     # the model axis splits the positions

The reference lowers and compiles each cell's jitted step for 256 or 512
fake XLA host devices and reads the HLO. The port has no compiler to ask:
each cell joins a fake ``torch.distributed`` process group of 256 (16x16)
or 512 (2x16x16) ranks as rank 0, builds the mesh over it, and runs the
step once under a ``FakeTensorMode``: parameters, optimizer state, batch
and caches are DTensors whose shards are fake tensors at the real shard
shapes, so nothing is allocated and the collectives go nowhere.
``launch.op_analysis.analyze`` counts the run: dot FLOPs from
``torch.utils.flop_counter``'s formulas, collective bytes from the
functional collectives' result shapes. A train step's gradient
accumulation traces its first microbatch and counts it ``accum`` times
(the microbatches are the same ops on the same shapes; the reference
multiplies its accumulation scan's body by the trip count the same way).
The kernels cannot launch on fake tensors, so the step runs the plain
versions, except the selective scan, whose plain version loops over time:
a cell runs it as a shape-only stand-in (elementwise, no dot
counted, as the reference's HLO counts no dots for its Pallas scan).

On a model axis above 1 each rank's products are its tensor-parallel
share (``Model``'s column- and row-parallel regions): its query heads, its
hidden units, its Mamba channels, its vocabulary columns, so a 16x16
cell's dot FLOPs a shard are about a sixteenth of the 16x1 cell's (the
``"d"`` MoE's expert products excepted: every model rank runs its data
shard's ``E x cap`` rows, as the reference's do), and its collectives gain
the row-parallel products' all-reduces. ``--opt
activation_partitioning=seq`` lowers the sequence-parallel mode (each
region gathers the stripes and reduce-scatters back to them): its dot
FLOPs are the batch cell's, its collectives the stripes' gathers and
reduce-scatters in place of the all-reduces; ``pick_accum`` divides the
activation footprint by the model axis, as the reference's does.

Unlike the reference (which sets ``XLA_FLAGS`` at import), importing this
module changes nothing: ``run_cell`` creates the fake group, and destroys
it before it returns, on success or failure.

The roofline uses the card's data-sheet rates (NVIDIA H100 80GB HBM3, SXM,
700 W), not the reference's v5e constants. The collective term divides by
one card's NVLink rate, but a 16x16 mesh of 8-card hosts spans 32 hosts, so
most of its traffic would cross the slower inter-host network: the term is
a lower bound.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ALIASES, SHAPES, cells_for
from repro_torch.launch.mesh import P, make_mesh, make_production_mesh
from repro_torch.launch.op_analysis import OpCounter, analyze
from repro_torch.launch.specs import analytic_model_flops, batch_specs, pick_accum, sds, sds_tree
from repro_torch.models.layers import Axes
from repro_torch.models.model import Model
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.pytree import tree_leaves
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

__all__ = ["CARD", "HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "lower_cell", "main", "parse_overrides",
           "run_cell"]

# data-sheet rates of the card the roofline is drawn for (one card)
CARD = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way
CARD_BYTES = 80e9
COLLECTIVE_NOTE = ("lower bound: one card's NVLink rate, but a 16x16 mesh of 8-card hosts "
                   "spans 32 hosts, so most of its traffic crosses the inter-host network")


@contextlib.contextmanager
def shape_only_scan():
    """The selective scan as a shape-only stand-in while a cell runs: the
    plain version loops over every time step, which a 32k or 500k sequence
    cannot afford even on fake tensors. The stand-in's outputs have the
    scan's shapes and dtypes and depend on every input (so the backward
    reaches them all), through elementwise ops only."""
    from repro_torch.models import mamba

    def stand_in(x, dt, a, b, c, d_skip):
        mix = (b.float().sum(-1, keepdim=True) + c.float().sum(-1, keepdim=True))
        y = (x.float() * dt.float() * d_skip.float() + mix).to(x.dtype)
        h = a.float()[None] * (x.float()[:, -1, :, None] * dt.float()[:, -1, :, None])
        return y, h

    saved = mamba.selective_scan
    mamba.selective_scan = stand_in
    try:
        yield
    finally:
        mamba.selective_scan = saved


def _config(arch: str, overrides: dict | None):
    from repro_torch.launch.train import get_model_config

    cfg = get_model_config(arch)  # "reduced:<arch>" and "repro-100m" too
    overrides = dict(overrides or {})
    force_accum = overrides.pop("accum", None)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, force_accum


def _mesh(multi_pod: bool, mesh_shape: tuple | None):
    """The production mesh, or a ``(data, model)``/``(pod, data, model)``
    mesh of ``mesh_shape`` (tests), over the current process group."""
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    names = ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")
    return make_mesh(tuple(mesh_shape), names)


def lower_cell(arch: str, shape_name, multi_pod: bool, overrides: dict | None = None,
               mesh=None, counter: OpCounter | None = None):
    """One cell's step and its sharded stand-in arguments on ``mesh`` (the
    production mesh over the current process group, built before the
    caller's fake mode: a mesh reads its rank map), inside that fake mode.
    Returns ``(step, args, mesh, meta)``; ``meta`` holds ``accum`` and the
    ``model``. With ``counter`` a train step traces its first microbatch
    under ``counter.repeat(accum)`` in place of all ``accum``. ``shape_name``
    names a ``SHAPES`` entry, or is such a dict itself."""
    cfg, force_accum = _config(arch, overrides)
    mesh = mesh or _mesh(multi_pod, None)
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    tp = "model"
    model = Model(cfg, "cpu", ax=Axes(dp=dp, tp=tp), mesh=mesh)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    kind = shape["kind"]
    n_dp = 1
    for a in dp:
        n_dp *= mesh.size(mesh.mesh_dim_names.index(a))
    params = sds_tree(model.init_shapes(), model.param_specs(), mesh)
    meta = {"accum": 1, "model": model}
    if kind == "train":
        n_tp = mesh.size(mesh.mesh_dim_names.index(tp)) \
            if cfg.activation_partitioning == "seq" else 1
        accum = int(force_accum) if force_accum else pick_accum(cfg, shape, n_dp, n_tp=n_tp)
        meta["accum"] = accum
        opt = adamw_init(params, cfg.opt_state_dtype)  # placed as the parameters
        batch = batch_specs(cfg, shape, mesh, dp, accum=accum)
        sample = counter.repeat if counter is not None else None
        return (make_train_step(model, accum=accum, sample=sample), (params, opt, batch),
                mesh, meta)
    if kind == "prefill":
        batch = batch_specs(cfg, shape, mesh, dp)
        return make_prefill_step(model), (params, batch), mesh, meta
    b, s = shape["global_batch"], shape["seq_len"]
    cache = sds_tree(model.init_cache(b, s), model.cache_specs(), mesh)
    tokens = sds((b, 1), torch.int32, P(dp, None), mesh)
    # the last position: the step writes it and attends over the whole cache
    return make_decode_step(model), (params, cache, tokens, s - 1), mesh, meta


def _shard_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _peak_bytes(step, args) -> tuple[int | None, str | None]:
    """The step's peak of live tensor bytes on this rank from
    ``torch.distributed._tools.mem_tracker.MemTracker`` under the fake mode
    (arguments included), or ``(None, reason)``."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError as err:  # pragma: no cover - depends on the torch build
        return None, f"MemTracker unavailable: {err}"
    try:
        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
        with tracker:
            step(*args)
        peak = tracker.get_tracker_snapshot("peak")
        return int(sum(v.get("Total", 0) for v in peak.values())), None
    except Exception as err:  # MemTracker is private API; report, never fail the cell
        return None, f"MemTracker failed: {type(err).__name__}: {err}"


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides: dict | None = None,
             peak: bool = True, mesh_shape: tuple | None = None) -> dict:
    """One cell's record (the reference's keys wherever the meaning carries
    over). Creates the fake process group (of the production mesh's size,
    or of ``mesh_shape``'s) and destroys it before returning; raises if a
    process group already exists."""
    import logging

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    t0 = time.time()
    cfg, _ = _config(arch, overrides)
    status = cells_for(arch, cfg)[shape_name]
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    chips = math.prod(mesh_shape)
    result = {"arch": arch, "shape": shape_name, "mesh": "x".join(map(str, mesh_shape)),
              "status": status}
    if status != "run":
        return result
    kind = SHAPES[shape_name]["kind"]
    if overrides:
        result["overrides"] = {k: str(v) for k, v in overrides.items()}
    if dist.is_initialized():
        raise RuntimeError("run_cell makes its own fake process group; one is initialised")
    # DTensor warns at every gather over two mesh dims (pod and data); the
    # counts are what the record is for
    logger = logging.getLogger("torch.distributed.tensor._redistribute")
    level = logger.level
    logger.setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=chips)
    try:
        mesh = _mesh(multi_pod, mesh_shape)
        counter = OpCounter()
        with FakeTensorMode(), shape_only_scan():
            step, args, mesh, meta = lower_cell(arch, shape_name, multi_pod, overrides, mesh,
                                                counter)
            t_lower = time.time()
            arg_bytes = _shard_bytes(args)
            h = analyze(step, *args, trip_count=cfg.n_blocks, counter=counter)
            t_trace = time.time()
            peak_bytes, peak_note = _peak_bytes(step, args) if peak else (None, "not asked")
        model_fl = analytic_model_flops(cfg, SHAPES[shape_name], kind)
        dot_total = h["dot_flops_per_shard"] * chips
        result.update(
            status="ok",
            chips=chips,
            accum=meta["accum"],
            lower_s=round(t_lower - t0, 1),
            trace_s=round(t_trace - t_lower, 1),
            memory={"argument_bytes": arg_bytes, "peak_bytes": peak_bytes,
                    "peak_note": peak_note,
                    "argument_bytes_fit_80gb": arg_bytes <= CARD_BYTES},
            dot_flops_per_shard=h["dot_flops_per_shard"],
            dot_flops_total=dot_total,
            collective_bytes_per_shard=h["collective_bytes"],
            collective_counts=h["collective_counts"],
            total_collective_bytes_per_shard=h["total_collective_bytes"],
            max_trip_count=h["max_trip_count"],
            **model_fl,
        )
        result["roofline"] = {
            "card": CARD, "peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
            "nvlink_bytes_per_s": NVLINK_BW,
            "compute_s": dot_total / (chips * PEAK_FLOPS),
            # every argument shard read once: a lower bound on memory time
            "memory_s_lower": arg_bytes / HBM_BW,
            "collective_s": h["total_collective_bytes"] / NVLINK_BW,
            "collective_note": COLLECTIVE_NOTE,
            "model_flops_ratio": model_fl["model_flops"] / dot_total if dot_total else None,
        }
    except Exception as e:
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    finally:
        dist.destroy_process_group()
        logger.setLevel(level)
    result["wall_s"] = round(time.time() - t0, 1)
    return result


def parse_overrides(text: str | None) -> dict | None:
    """``"k=v,k=v"`` as a dict of config overrides (ints, floats, else strings)."""
    if not text:
        return None
    out = {}
    for kv in text.split(","):
        k, v = kv.split("=")
        if v.isdigit():
            out[k] = int(v)
        else:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--opt", default=None,
                    help="comma-separated cfg overrides, e.g. "
                         "moe_weight_shard=f,opt_state_dtype=bfloat16 (accum=N forces accum)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a worker process of its own")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cells = [(arch, shape, mp) for arch in ALIASES for shape in SHAPES for mp in (False, True)]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]
    overrides = parse_overrides(args.opt)
    todo = []
    for arch, shape, mp in cells:
        tag = f"{ALIASES.get(arch, arch)}_{shape}_{'multi' if mp else 'single'}"
        if args.tag:
            tag += f"_{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip cached] {tag}")
            continue
        todo.append((tag, path, (arch, shape, mp, overrides)))
    errors = 0
    t0 = time.time()
    for tag, path, res in _run_all(todo, args.jobs):
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        errors += res["status"] == "error"
        print(
            f"[done] {tag} -> {res['status']}"
            + (f" trace={res.get('trace_s')}s wall={res.get('wall_s')}s"
               f" dotTFLOP={res.get('dot_flops_total', 0) / 1e12:.1f}"
               f" coll/shard={res.get('total_collective_bytes_per_shard', 0) / 1e6:.0f}MB"
               if res["status"] == "ok" else f" {res.get('error', '')[:200]}"),
            flush=True,
        )
    print(f"[dryrun] {len(todo)} cells in {time.time() - t0:.1f}s, {errors} errors", flush=True)
    return 1 if errors else 0


def _run_all(todo: list, jobs: int):
    """``(tag, path, record)`` of each cell, in order of completion: in this
    process, or in ``jobs`` spawned worker processes (each cell makes and
    destroys its own fake group in the worker)."""
    if jobs <= 1:
        for tag, path, cell in todo:
            print(f"[run] {tag}", flush=True)
            yield tag, path, run_cell(*cell)
        return
    import concurrent.futures
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        futures = {pool.submit(run_cell, *cell): (tag, path) for tag, path, cell in todo}
        for fut in concurrent.futures.as_completed(futures):
            tag, path = futures[fut]
            yield tag, path, fut.result()


if __name__ == "__main__":
    raise SystemExit(main())
