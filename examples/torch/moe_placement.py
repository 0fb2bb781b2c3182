"""CUTTANA expert placement on the PyTorch port: partition the expert
co-activation graph to cut MoE all-to-all fanout (the paper's technique
applied inside the LM half). The placement is host numpy; ``--device``
(default ``cuda``) is checked as every entry point of the port checks it.

    PYTHONPATH=src python examples/torch/moe_placement.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.placement import (
    evaluate_placement,
    place_experts,
    synthetic_routing_trace,
)
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
resolve_device(args.device)

E, K_DEV, TOP_K = 160, 16, 6  # deepseek-v2-236b on a 16-way EP axis
trace = synthetic_routing_trace(50_000, E, TOP_K, skew=0.7, seed=0)

baseline = np.arange(E) % K_DEV  # round-robin (the default EP layout)
contig = np.repeat(np.arange(K_DEV), E // K_DEV)
placed = place_experts(trace, E, K_DEV, seed=0)

for name, pl in [("round-robin", baseline), ("contiguous", contig),
                 ("cuttana", placed)]:
    m = evaluate_placement(trace, pl)
    print(
        f"{name:<12} mean A2A fanout/token = {m['mean_fanout']:.3f} "
        f"(max {m['max_fanout']:.0f}), device load imb = "
        f"{m['device_load_imbalance']:.3f}"
    )

m0 = evaluate_placement(trace, baseline)
m1 = evaluate_placement(trace, placed)
gain = 1 - m1["mean_fanout"] / m0["mean_fanout"]
print(f"\nCUTTANA placement cuts mean per-token A2A fanout by {gain:.1%}")
assert m1["mean_fanout"] <= m0["mean_fanout"]
