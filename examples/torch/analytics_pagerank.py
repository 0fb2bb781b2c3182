"""Distributed analytics on the PyTorch port: PageRank/CC/SSSP across
partitioners with the network cost model (paper Table IV in miniature).

    PYTHONPATH=src python examples/torch/analytics_pagerank.py               # on a CUDA card
    PYTHONPATH=src python examples/torch/analytics_pagerank.py --device cpu  # plain PyTorch versions
"""
import argparse

import numpy as np

from repro_torch.analytics import (
    GraphEngine,
    cc_program,
    localize,
    pagerank_program,
    sssp_program,
    workload_cost,
)
from repro_torch.analytics.programs import reference_pagerank
from repro_torch.core import get_edge_partitioner, get_partitioner
from repro_torch.graph import powerlaw_cluster_graph

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

K = 8
graph = powerlaw_cluster_graph(30_000, avg_degree=12, seed=1)

print(f"{'partitioner':<12} {'PR(30)':>9} {'CC(20)':>9} {'SSSP(20)':>9} straggler")
for name in ("random", "ldg", "fennel", "heistream", "cuttana", "hdrf", "ginger"):
    if name in ("hdrf", "ginger"):
        assignment = get_edge_partitioner(name)(graph, K, seed=0, device=args.device)
    else:
        assignment = get_partitioner(name)(
            graph, K, balance_mode="edge" if name == "cuttana" else "vertex",
            order="random", seed=0, device=args.device,
        )
    cols = []
    for iters in (30, 20, 20):
        cost = workload_cost(graph, assignment, K, iters)
        cols.append(cost["total_s"] * 1e3)
    print(
        f"{name:<12} {cols[0]:>8.2f}ms {cols[1]:>8.2f}ms {cols[2]:>8.2f}ms "
        f"{cost['straggler_ratio']:.2f}"
    )

# correctness: engine vs dense reference
part = get_partitioner("cuttana")(graph, K, balance_mode="edge", seed=0, device=args.device)
lg = localize(graph, part, K)
got = GraphEngine(lg, pagerank_program(), device=args.device).run_simulated(iters=15)
want = reference_pagerank(graph, iters=15)
err = float(np.abs(got - want).max())
print(f"engine vs dense reference max|err| = {err:.2e}")
assert err < 1e-6
