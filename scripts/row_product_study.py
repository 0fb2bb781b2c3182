"""A row-parallel product's partial on the card: bf16 operands with a float32
result (``models/layers.py`` ``row_product``, ``torch.mm``'s ``out_dtype``)
against the same product on float32 copies of the operands, and the plain
bf16 product, at the shapes a tensor-parallel rank runs.

Shapes (rows = B x T of one microbatch): qwen3-8b's ``train_4k`` layer on a
model axis of 16 (``wo``: 256 of 4,096 input rows; ``w_out``: 768 of
12,288), and repro-100m's on 1x2 (B=8, T=256; ``wo`` 320 of 640, ``w_out``
1,280 of 2,560). Each form is timed with CUDA events, the median of
``--reps`` calls after warm-up, and its float32 result held against the
float64 product of the same operands. Prints one JSON object a shape.

    PYTHONPATH=src python scripts/row_product_study.py [--reps 50]
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.models.layers import row_product

# (name, rows, k, n)
SHAPES = (("qwen3_tp16_wo", 8192, 256, 4096), ("qwen3_tp16_w_out", 8192, 768, 4096),
          ("repro100m_1x2_wo", 2048, 320, 640), ("repro100m_1x2_w_out", 2048, 1280, 640))


def _median_ms(fn, reps: int) -> float:
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, m, k, n in SHAPES:
        y = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5).bfloat16()
        want = y.double() @ w.double()
        forms = {"bf16_in_f32_out": lambda: row_product(y, w, True),
                 "f32_copies": lambda: y.float() @ w.float(),
                 "bf16": lambda: y @ w}
        row = {"shape": name, "m": m, "k": k, "n": n}
        for form, fn in forms.items():
            out = fn().double()
            row[f"{form}_ms"] = _median_ms(fn, args.reps)
            row[f"{form}_rel_err"] = float((out - want).norm() / want.norm())
        print(json.dumps(row))


if __name__ == "__main__":
    main()
