"""End-to-end training driver with fault tolerance (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch reduced:qwen3-8b \
        --steps 30 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch reduced:qwen3-8b \
        --mesh 2x1 --device cpu              # two ranks over gloo

What it exercises:
  * seeded parameters (``torch.Generator`` seed 0 on the device) and AdamW
    state in ``cfg.opt_state_dtype``,
  * ``make_train_step`` with the attention and scan kernels in the forward,
  * any ``--mesh`` ``DxM`` or ``PxDxM`` (axes ``data, model`` or ``pod,
    data, model``): parameters and AdamW state are DTensors placed by
    ``Model.param_specs``, each rank trains on its batch rows with each
    layer's weights gathered (``repro_torch.models.model``). With more than
    one rank the command starts its own ranks (spawned processes joined
    through a file store) or, under ``torchrun`` or an initialised process
    group, runs as one of them. Ranks that each have a card join over NCCL
    on a ``cuda`` mesh; ranks that share a card (or the CPU) join over gloo
    and keep their DTensors on a host mesh, each gathered layer copied to
    the card (gloo's CUDA support is partial),
  * async atomic checkpoints every ``--ckpt-every`` steps, keep-N, in the
    reference's file format and leaf order (a checkpoint of either package
    resumes in the other, and one written on any mesh resumes on any other:
    the ranks gather the state whole and rank 0 writes it),
  * crash-restart: ``--fail-at N`` raises after step N; rerunning with the
    same ``--ckpt-dir`` resumes from the latest checkpoint, the data
    pipeline included (``TokenPipeline.skip_to``).

The command line has no flag for the sharding fields, as the reference's
has none; a caller in Python sets them on the config, ``main(argv,
overrides={"activation_partitioning": "seq"})`` (the dry run's ``--opt``
does the same), and every rank trains that config.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import sys
import time

import torch

from repro_torch.configs import get_model_config as _get_config
from repro_torch.convert import lm_params_from_arrays, lm_params_to_reference
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import P, gather_tree, make_mesh, shard, shard_tree
from repro_torch.launch.ranks import rank_device, run_in_group
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import Axes
from repro_torch.models.model import Model
from repro_torch.train.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import AdamWState, adamw_init
from repro_torch.train.pytree import tree_map
from repro_torch.train.step import make_train_step


def repro_100m() -> ModelConfig:
    """~100M-param llama-style model for the end-to-end example (the
    reference's; 89M parameters)."""
    return ModelConfig(
        name="repro-100m",
        family="dense",
        d_model=640,
        vocab_size=32768,
        block=(LayerSpec("attn", "dense"),),
        n_blocks=10,
        n_heads=10,
        n_kv_heads=5,
        d_ff=1792,
        activation="swiglu",
        remat=False,
    )


def get_model_config(name: str) -> ModelConfig:
    if name == "repro-100m":
        return repro_100m()
    return _get_config(name)


def mesh_dims(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``(shape, axis names)`` of ``"DxM"`` or ``"PxDxM"``."""
    try:
        dims = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        dims = ()
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh takes DxM or PxDxM with positive sizes, got {spec!r}")
    return dims, (("data", "model") if len(dims) == 2 else ("pod", "data", "model"))


def build_mesh(spec: str, device_type: str = "cpu"):
    """The ``DeviceMesh`` of ``spec`` over the process group (whose size
    must be the mesh's), or ``None`` for a one-rank mesh with no group (the
    one-device path)."""
    import torch.distributed as dist

    dims, names = mesh_dims(spec)
    if math.prod(dims) == 1 and not dist.is_initialized():
        return None
    return make_mesh(dims, names, device_type)


def checkpoint_tree(cfg: ModelConfig, params: dict, opt: AdamWState):
    """``(params, opt_state)`` in the reference's layout and leaf order."""
    return (lm_params_to_reference(cfg, params),
            AdamWState(step=opt.step, m=lm_params_to_reference(cfg, opt.m),
                       v=lm_params_to_reference(cfg, opt.v)))


def restore(directory: str, cfg: ModelConfig, params: dict, opt: AdamWState,
            device: torch.device):
    """``(params, opt_state, step)`` from the latest checkpoint in
    ``directory``, on ``device`` in the port's layout."""
    like = checkpoint_tree(cfg, *tree_map(lambda t: t.to("meta"), (params, opt)))
    (p_ref, o_ref), step = restore_checkpoint(directory, like)
    params = lm_params_from_arrays(cfg, p_ref, device)
    opt = AdamWState(step=o_ref.step.to(device), m=lm_params_from_arrays(cfg, o_ref.m, device),
                     v=lm_params_from_arrays(cfg, o_ref.v, device))
    return params, opt, step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash after this step (fault-tolerance demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits with an error without a card) or cpu")
    ap.add_argument("--dtype", default=None,
                    help="the parameters' dtype in place of the config's (e.g. float32)")
    return ap


def main(argv=None, history: list | None = None, overrides: dict | None = None):
    """Train; returns the last step's loss. ``history``, when given, gets
    each step's metrics as floats (``step``, ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr``, and the step's host seconds ``step_s``); with
    ranks, rank 0's. ``overrides`` replace fields of the ``--arch`` config
    (``dataclasses.replace``), ``--dtype`` after them."""
    import torch.distributed as dist

    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    dims, _ = mesh_dims(args.mesh)
    if math.prod(dims) == 1 or dist.is_initialized():  # one device, or a rank of a group
        return train(args, history, overrides)
    out = run_in_group(functools.partial(_train_rank, overrides=overrides), argv, args.device,
                       math.prod(dims))
    if history is not None:
        history.extend(out.get("history", []))
    if "error" in out:
        raise RuntimeError(out["error"])
    return out["loss"]


def _train_rank(argv: list, out: dict, overrides: dict | None = None) -> None:
    """One rank's run: ``out`` gets its history and loss."""
    out["history"] = []
    out["loss"] = train(_parser().parse_args(argv), out["history"], overrides)


def train(args, history: list | None = None, overrides: dict | None = None):
    """The training loop of one rank (or of the one device): ``args`` as
    :func:`main` parses them, ``overrides`` as :func:`main` takes them."""
    import torch.distributed as dist

    device = resolve_device(args.device)
    mesh, rank = None, 0
    if dist.is_initialized():
        rank = dist.get_rank()
        device = rank_device(args.device, rank, dist.get_world_size())
        mesh = build_mesh(args.mesh, "cuda" if dist.get_backend() == "nccl" else "cpu")
    else:
        build_mesh(args.mesh)  # a mesh of more than one rank needs a group: raises
    main_rank = rank == 0
    cfg = dataclasses.replace(get_model_config(args.arch), **(overrides or {}))
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    dp = ("pod", "data") if mesh is not None and "pod" in mesh.mesh_dim_names else ("data",)
    model = Model(cfg, device, ax=Axes(dp=dp, tp="model"), mesh=mesh)
    train_step = make_train_step(
        model, peak_lr=args.lr, warmup=min(100, args.steps // 10 + 1),
        total_steps=args.steps,
    )
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = adamw_init(params, cfg.opt_state_dtype)

    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir and main_rank else None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        params, opt_state, start_step = restore(args.ckpt_dir, cfg, params, opt_state, device)
        if main_rank:
            print(f"[restore] resumed from step {start_step}")
    if mesh is not None:  # every rank holds the whole state; keep its shards
        specs = model.param_specs()
        params = shard_tree(params, specs, mesh)
        # the step counter beside the shards (a host mesh keeps them off the card)
        opt_state = AdamWState(step=opt_state.step.to(mesh.device_type),
                               m=shard_tree(opt_state.m, specs, mesh),
                               v=shard_tree(opt_state.v, specs, mesh))

    def save(step: int) -> None:
        tree = (params, opt_state)
        if mesh is not None:  # every rank takes part in the gathers
            tree = (gather_tree(params), AdamWState(step=opt_state.step,
                                                    m=gather_tree(opt_state.m),
                                                    v=gather_tree(opt_state.v)))
        if ckpt:
            ckpt.save(step, checkpoint_tree(cfg, *tree))

    pipe = TokenPipeline(
        cfg.vocab_size, args.seq_len, args.global_batch, seed=1234
    )
    pipe.skip_to(start_step)

    t0 = time.time()
    tokens_done = 0
    metrics = None
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(torch.int64) for k, v in next(pipe).items()}
        if mesh is None:
            batch = {k: v.to(device) for k, v in batch.items()}
        else:
            batch = {k: shard(v, P(dp, None), mesh) for k, v in batch.items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        tokens_done += args.global_batch * args.seq_len
        m = {k: float(v) for k, v in metrics.items()}
        if history is not None:
            history.append({"step": step + 1, **m, "step_s": time.perf_counter() - t_step})
        if main_rank and ((step + 1) % args.log_every == 0 or step + 1 == args.steps):
            tps = tokens_done / max(time.time() - t0, 1e-9)
            print(
                f"step {step+1:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} tok/s={tps:,.0f}",
                flush=True,
            )
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
        if args.fail_at is not None and step + 1 == args.fail_at:
            if ckpt:
                ckpt.wait()
            pipe.close()
            raise RuntimeError(
                f"[injected failure] node died at step {step+1}; "
                f"rerun with the same --ckpt-dir to resume"
            )
    if args.ckpt_dir:
        save(args.steps)
        if ckpt:
            ckpt.wait()
    pipe.close()
    if main_rank:
        print("[done]")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
