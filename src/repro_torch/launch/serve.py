"""Batched serving launcher: prefill into the cache, then a greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --batch 8 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch reduced:qwen3-8b \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
        --n-blocks 1 --batch 8 --prompt-len 128 --gen 32

``--n-blocks`` cuts the depth at full width, for a model that does not fit
one card (deepseek-v2-236b: its dense prefix layer and one MoE block of the
59 are 5.36B parameters).

``--mesh DxM`` (or ``PxDxM``) serves on a device mesh, as the reference's
launcher does: the parameters and the decode caches are DTensors placed by
``Model.param_specs``/``cache_specs``, the batch split over the data axes;
each step gathers a layer's weights over the data axes (on a model axis
above 1 each rank keeps its chunks and runs its own heads and channels)
and its cache stripes, and an MoE with
``moe_weight_shard="f"`` (``--opt moe_weight_shard=f``) runs
``moe_ffn_fshard`` with its expert weights where they lie. The ranks start
as ``launch.ranks`` says (spawned, or under ``torchrun``); the tokens come
back whole on every rank.

Serves a model with seeded random weights (``torch.Generator`` seed 0) on
one card, or on the CPU when asked. As in the reference's launcher, the prompt
is prefilled through one decode step per token (correct for every mixer);
``make_prefill_step`` is the full-sequence forward.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_model_config
from repro_torch.launch.mesh import P, local_slice, placements, shard_tree
from repro_torch.launch.ranks import rank_device, run_in_group
from repro_torch.launch.specs import contiguous_stride, sanitize_spec
from repro_torch.launch.train import build_mesh, mesh_dims
from repro_torch.models.layers import Axes
from repro_torch.models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_into_cache(model: Model, params: dict, cache: list, tokens: torch.Tensor,
                       wrap=None):
    """Sequential prefill via decode steps. tokens: [B, T]. Returns the last
    step's logits [B, 1, V] and the cache. ``wrap`` makes each step's
    tokens what ``decode_step`` takes (on a mesh, the batch's DTensor)."""
    logits = None
    for pos in range(tokens.shape[1]):
        step_tokens = tokens[:, pos : pos + 1]
        logits, cache = model.decode_step(params, cache,
                                          wrap(step_tokens) if wrap else step_tokens, pos)
    return logits, cache


def _placed(model: Model, prompts: torch.Tensor, length: int):
    """``(cache, prompts, wrap, rows)`` for a loop over ``length``
    positions: the cache (this rank's shards on a mesh), this rank's rows of
    ``prompts`` [B, T], what makes this rank's rows ``[B_r, n]`` of a step's
    tokens or ids the batch's DTensor, and the rows' placements (``None``
    and ``None`` on one device)."""
    b, plen = prompts.shape
    cache = model.init_cache(b, length)
    if model.mesh is None:
        return cache, prompts, None, None
    from torch.distributed.tensor import DTensor

    mesh = model.mesh
    cache = shard_tree(cache, model.cache_specs(), mesh)
    rows = placements(sanitize_spec((b, plen), P(model.ax.dp, None), mesh), mesh)

    def wrap(t):  # this rank's rows as the batch's DTensor
        return DTensor.from_local(t.to(mesh.device_type), mesh, rows, run_check=False,
                                  shape=(b, t.shape[1]), stride=contiguous_stride((b, t.shape[1])))

    return cache, local_slice(prompts, rows, mesh), wrap, rows


def serve(model: Model, params: dict, prompts: torch.Tensor, gen: int):
    """Prefill ``prompts`` [B, T] and generate ``gen`` tokens greedily
    (argmax, the first maximum on ties, as ``jnp.argmax``). Returns the
    generated ids [B, gen] and host-clock timings with the device
    synchronised: ``prefill_s``, ``decode_s`` (the ``gen - 1`` decode steps
    after the prefill) and ``decode_tok_per_s``. On a mesh ``params`` are
    DTensors, ``prompts`` the whole batch (on every rank), and every rank
    gets every row's ids back."""
    b, plen = prompts.shape
    cache, prompts, wrap, _ = _placed(model, prompts, plen + gen)
    t0 = time.perf_counter()
    logits, cache = prefill_into_cache(model, params, cache, prompts, wrap)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(model.device)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(params, cache, wrap(tok) if wrap else tok, plen + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    _sync(model.device)
    t_decode = time.perf_counter() - t0
    timings = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": b * (gen - 1) / t_decode if gen > 1 else None,
    }
    ids = torch.cat(out, dim=1)
    if wrap is not None:
        ids = wrap(ids).full_tensor().to(model.device)
    return ids, timings


def forced_logits(model: Model, params: dict, prompts: torch.Tensor,
                  forced: torch.Tensor) -> torch.Tensor:
    """Teacher forcing: prefill ``prompts`` [B, T], then feed ``forced``
    [B, gen] (the whole batch) one token a step in place of the greedy
    choice. Returns every step's logits ``[gen, B, V]`` in float32 on the
    host: the prefill's last and the ``gen - 1`` decode steps', every row on
    every rank of a mesh. Two runs that score the same tokens can be held
    against each other step by step, where their greedy loops part after a
    near tie."""
    b, plen = prompts.shape
    gen = forced.shape[1]
    cache, prompts, wrap, rows = _placed(model, prompts, plen + gen)
    if rows is not None:
        forced = local_slice(forced, rows, model.mesh)
    ids = torch.cat([prompts, forced.to(prompts.device)], 1)
    out = []
    for pos in range(plen + gen - 1):
        tok = ids[:, pos:pos + 1]
        logits, cache = model.decode_step(params, cache, wrap(tok) if wrap else tok, pos)
        if pos >= plen - 1:
            out.append(logits[:, -1].float())
    steps = torch.stack(out, 1)  # [B_r, gen, V]
    if rows is not None:
        from torch.distributed.tensor import DTensor

        steps = DTensor.from_local(steps.to(model.mesh.device_type), model.mesh, rows,
                                   run_check=False,
                                   shape=(b, *steps.shape[1:]),
                                   stride=contiguous_stride((b, *steps.shape[1:]))).full_tensor()
    return steps.transpose(0, 1).cpu()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="reduced:qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="cut the depth to this many blocks, at full width")
    ap.add_argument("--opt", default=None,
                    help="comma-separated config overrides, e.g. moe_weight_shard=f")
    return ap


def _config(args):
    cfg = get_model_config(args.arch)
    if args.n_blocks is not None:
        cfg = dataclasses.replace(cfg, n_blocks=args.n_blocks)
    if args.opt:
        from repro_torch.launch.dryrun import parse_overrides

        cfg = dataclasses.replace(cfg, **parse_overrides(args.opt))
    return cfg


def run(args) -> tuple[torch.Tensor, dict]:
    """Serve as ``args`` say in this process (the one device, or one rank
    of the mesh's process group): ``(ids [B, gen], timings)``."""
    return serve(*setup(args), args.gen)


def setup(args) -> tuple[Model, dict, torch.Tensor]:
    """``(model, params, prompts)`` as ``args`` say, in this process (the
    one device, or one rank of the mesh's process group: ``params`` its
    shards, ``prompts`` the whole batch): the random parameters of seed 0
    and prompts of seed 0."""
    import torch.distributed as dist

    cfg = _config(args)
    if cfg.is_encoder_only:
        raise SystemExit("encoder-only arch has no decode path")
    device, mesh = args.device, None
    if dist.is_initialized():
        device = rank_device(args.device, dist.get_rank(), dist.get_world_size())
        mesh = build_mesh(args.mesh, "cuda" if dist.get_backend() == "nccl" else "cpu")
    else:
        build_mesh(args.mesh)  # a mesh of more than one rank needs a group: raises
    dp = ("pod", "data") if mesh is not None and "pod" in mesh.mesh_dim_names else ("data",)
    model = Model(cfg, device, ax=Axes(dp=dp, tp="model"), mesh=mesh)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(2, cfg.vocab_size, (args.batch, args.prompt_len)), device=model.device
    )
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    if mesh is not None:
        params = shard_tree(params, model.param_specs(), mesh)
    return model, params, prompts


def _serve_rank(argv: list, out: dict) -> None:
    gen, t = run(_parser().parse_args(argv))
    out["gen"], out["timings"] = gen.cpu().tolist(), t


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    dims, _ = mesh_dims(args.mesh)
    if math.prod(dims) == 1:
        gen, t = run(args)
    else:
        out = run_in_group(_serve_rank, argv, args.device, math.prod(dims))
        if "error" in out:
            raise RuntimeError(out["error"])
        gen, t = torch.tensor(out["gen"]), out["timings"]
    print("generated token ids:\n", gen.cpu().numpy())
    print(
        f"prefill {args.prompt_len} tok x{args.batch}: {t['prefill_s']:.2f}s; "
        f"decode: {args.gen - 1} steps in {t['decode_s']:.2f}s "
        f"({t['decode_tok_per_s'] or 0.0:.1f} tok/s)"
    )
    return gen


if __name__ == "__main__":
    main()
