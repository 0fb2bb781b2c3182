"""End-to-end training driver with fault tolerance (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch reduced:qwen3-8b \\
        --steps 30 --device cpu

What it exercises:
  * seeded parameters (``torch.Generator`` seed 0 on the device) and AdamW
    state in ``cfg.opt_state_dtype``,
  * ``make_train_step`` with the attention and scan kernels in the forward,
  * async atomic checkpoints every ``--ckpt-every`` steps, keep-N, in the
    reference's file format and leaf order (a checkpoint of either package
    resumes in the other),
  * crash-restart: ``--fail-at N`` raises after step N; rerunning with the
    same ``--ckpt-dir`` resumes from the latest checkpoint, the data
    pipeline included (``TokenPipeline.skip_to``).

The port runs on one card: ``--mesh`` takes ``1x1`` only; a device mesh
(and the reference's sharding specs) waits for ROADMAP Queue 1 item 8d.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_model_config as _get_config
from repro_torch.convert import lm_params_from_arrays, lm_params_to_reference
from repro_torch.device import resolve_device
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.model import Model
from repro_torch.train.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import AdamWState, adamw_init
from repro_torch.train.pytree import tree_map
from repro_torch.train.step import make_train_step

MESH_ITEM = "ROADMAP Queue 1 item 8d (meshes and the sharding specs)"


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


def check_mesh(spec: str) -> None:
    """The port trains on one device: only ``1x1`` is accepted."""
    if spec != "1x1":
        raise NotImplementedError(
            f"--mesh {spec}: the port trains on one device (1x1); meshes wait for {MESH_ITEM}")


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


def main(argv=None, history: list | None = None):
    """Train; returns the last step's loss. ``history``, when given, gets
    each step's metrics as floats (``step``, ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr``)."""
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
    args = ap.parse_args(argv)

    check_mesh(args.mesh)
    device = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    model = Model(cfg, device)
    train_step = make_train_step(
        model, peak_lr=args.lr, warmup=min(100, args.steps // 10 + 1),
        total_steps=args.steps,
    )
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = adamw_init(params, cfg.opt_state_dtype)

    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        params, opt_state, start_step = restore(args.ckpt_dir, cfg, params, opt_state, device)
        print(f"[restore] resumed from step {start_step}")

    pipe = TokenPipeline(
        cfg.vocab_size, args.seq_len, args.global_batch, seed=1234
    )
    pipe.skip_to(start_step)

    t0 = time.time()
    tokens_done = 0
    metrics = None
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device, torch.int64) for k, v in next(pipe).items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        tokens_done += args.global_batch * args.seq_len
        if history is not None:
            history.append({"step": step + 1, **{k: float(v) for k, v in metrics.items()}})
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            tps = tokens_done / max(time.time() - t0, 1e-9)
            print(
                f"step {step+1:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} tok/s={tps:,.0f}",
                flush=True,
            )
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, checkpoint_tree(cfg, params, opt_state))
        if args.fail_at is not None and step + 1 == args.fail_at:
            if ckpt:
                ckpt.wait()
            pipe.close()
            raise RuntimeError(
                f"[injected failure] node died at step {step+1}; "
                f"rerun with the same --ckpt-dir to resume"
            )
    if ckpt:
        ckpt.save(args.steps, checkpoint_tree(cfg, params, opt_state))
        ckpt.wait()
    pipe.close()
    print("[done]")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
