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

Serves a model with seeded random weights (``torch.Generator`` seed 0) on
one card, or on the CPU when asked. As in the reference's launcher, the prompt
is prefilled through one decode step per token (correct for every mixer);
``make_prefill_step`` is the full-sequence forward.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_model_config
from repro_torch.models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_into_cache(model: Model, params: dict, cache: list, tokens: torch.Tensor):
    """Sequential prefill via decode steps. tokens: [B, T]. Returns the last
    step's logits [B, 1, V] and the cache."""
    logits = None
    for pos in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, pos : pos + 1], pos)
    return logits, cache


def serve(model: Model, params: dict, prompts: torch.Tensor, gen: int):
    """Prefill ``prompts`` [B, T] and generate ``gen`` tokens greedily
    (argmax, the first maximum on ties, as ``jnp.argmax``). Returns the
    generated ids [B, gen] and host-clock timings with the device
    synchronised: ``prefill_s``, ``decode_s`` (the ``gen - 1`` decode steps
    after the prefill) and ``decode_tok_per_s``."""
    b, plen = prompts.shape
    cache = model.init_cache(b, plen + gen)
    t0 = time.perf_counter()
    logits, cache = prefill_into_cache(model, params, cache, prompts)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(model.device)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(params, cache, tok, plen + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    _sync(model.device)
    t_decode = time.perf_counter() - t0
    timings = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": b * (gen - 1) / t_decode if gen > 1 else None,
    }
    return torch.cat(out, dim=1), timings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="reduced:qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="cut the depth to this many blocks, at full width")
    args = ap.parse_args(argv)

    cfg = get_model_config(args.arch)
    if args.n_blocks is not None:
        cfg = dataclasses.replace(cfg, n_blocks=args.n_blocks)
    if cfg.is_encoder_only:
        raise SystemExit("encoder-only arch has no decode path")
    model = Model(cfg, args.device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(2, cfg.vocab_size, (args.batch, args.prompt_len)), device=model.device
    )
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    gen, t = serve(model, params, prompts, args.gen)
    print("generated token ids:\n", gen.cpu().numpy())
    print(
        f"prefill {args.prompt_len} tok x{args.batch}: {t['prefill_s']:.2f}s; "
        f"decode: {args.gen - 1} steps in {t['decode_s']:.2f}s "
        f"({t['decode_tok_per_s'] or 0.0:.1f} tok/s)"
    )
    return gen


if __name__ == "__main__":
    main()
