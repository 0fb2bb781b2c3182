#!/usr/bin/env python3
"""How far MLA's absorbed decode on the card lands from the plain version,
call by call and end to end, on one CUDA card.

``chip_smoke.py`` phase 27 holds a deepseek-v2-236b decode step (bf16, full
width, its dense prefix layer and one MoE block, B=8, seeded weights and a
seeded 8,192-long latent cache, 7 steps before it) against the same step
with every attention call on the plain version: the logits' worst row
within 1e-2 relative L2. This script repeats that step and reports, for the
tensor-core kernel (``latent_wgmma``), the FMA kernel (``decode_latent``:
the same calls with the value copied, so that it is no view of the key) and
the plain version:

    calls   each attention call against the plain version on its own
            inputs: worst and mean row relative L2, and the share of the
            bf16 output elements that differ from the plain version's
    gate    the step's logits, row by row, against the plain step's; how
            many tokens of the MoE layer chose other experts than the plain
            step did; each token's router margin (its 6th largest expert
            probability less its 7th)

with the 7 steps before the gated one run on the tensor-core kernel, as the
smoke runs them, and again on the FMA kernel (``--steps-on fma``). Run from
the repository root on a machine with the card:

    python3 scripts/mla_gate_study.py [--steps-on kernel|fma]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps-on", choices=("kernel", "fma"), default="kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_gate_study: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_model_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import Model, attention, layers

    device = torch.device("cuda")
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = dataclasses.replace(get_model_config(cs.MLA_ARCH), n_blocks=1)
    model = Model(cfg, device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    b, seq, steps = 8, 8192, 8  # phase 27's latent_decode_part
    kernel = attention.flash_attention
    runs = {"kernel": kernel, "fma": lambda q, k, v, **kw: kernel(q, k, v.clone(), **kw),
            "plain": flash_attention_ref}
    top_k, routed, calls = layers.top_k, [], []

    def recording(probs, k):  # the experts each token chose, and its margin
        vals, idx = top_k(probs, k)
        top = probs.float().topk(k + 1, dim=-1).values
        routed.append((idx.sort(-1).values.cpu(), (top[:, k - 1] - top[:, k]).cpu()))
        return vals, idx

    def checked(q, k, v, causal=True, window=None, q_offset=0):
        want = flash_attention_ref(q, k, v, causal, window, q_offset).float()
        for name in ("kernel", "fma"):
            diff = runs[name](q, k, v, causal=causal, window=window, q_offset=q_offset).float() \
                - want
            rows = diff.norm(dim=-1) / want.norm(dim=-1)
            calls.append({"call": len(calls) // 2, "run": name, "max_row_rel_l2": float(rows.max()),
                          "mean_row_rel_l2": float(rows.mean()),
                          "elements_differing": float((diff != 0).float().mean())})
        return kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)

    with torch.no_grad():
        cache = model.init_cache(b, seq)
        cs.fill_cache(torch, cache, torch.Generator(device=model.device).manual_seed(27))
        rng = np.random.default_rng(27)
        tok = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, 1)), device=model.device)
        attention.flash_attention = runs[args.steps_on]
        try:
            for i in range(steps - 1):
                logits, cache = model.decode_step(params, cache, tok, seq - steps + i)
                tok = logits[:, -1].argmax(-1)[:, None]
        finally:
            attention.flash_attention = kernel
        outs = {}
        for name in ("plain", "kernel", "fma", "calls"):
            attention.flash_attention = checked if name == "calls" else runs[name]
            layers.top_k = recording
            fa.reset()
            try:
                logits, _ = model.decode_step(params, cs.clone_cache(cache), tok, seq - 1)
            finally:
                attention.flash_attention = kernel
                layers.top_k = top_k
            outs[name] = (logits.float(), list(routed), dict(fa.variant_launches))
            routed.clear()
    want, want_routed = outs["plain"][0], outs["plain"][1]
    for name in ("kernel", "fma"):
        got, got_routed, variants = outs[name]
        rows = ((got - want).norm(dim=-1) / want.norm(dim=-1)).flatten()
        print(json.dumps({
            "run": name, "steps_on": args.steps_on,
            "variants": {n: c for n, c in variants.items() if c},
            "logits_row_rel_l2": rows.tolist(), "gate": float(rows.max()) <= cs.FLASH_ROW_RTOL,
            "tokens_routed_otherwise": [int((a[0] != w[0]).any(-1).sum())
                                        for a, w in zip(got_routed, want_routed)],
            "device": ident}), flush=True)
    print(json.dumps({"router_margin_per_token": [w[1].tolist() for w in want_routed],
                      "steps_on": args.steps_on, "device": ident}), flush=True)
    for row in calls:
        print(json.dumps({**row, "steps_on": args.steps_on, "device": ident}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
