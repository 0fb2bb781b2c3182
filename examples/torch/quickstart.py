"""Quickstart on the PyTorch port: the full paper pipeline as three chained
calls through ``repro_torch.api`` - partition a graph with CUTTANA, compare
against FENNEL, then run distributed PageRank (the port's engine, simulated
K-device layout) and the graph-DB workload on the winning partition.

    PYTHONPATH=src python examples/torch/quickstart.py               # on a CUDA card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu  # plain PyTorch versions
"""
import argparse

import numpy as np

from repro_torch.api import PartitionSpec, partition
from repro_torch.graph import rmat_graph

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

K = 8
graph = rmat_graph(20_000, avg_degree=16, seed=0)
print(f"graph: {graph}")

results = {}
for name in ("fennel", "cuttana"):
    # call 1: spec -> result (uniform across the whole algorithm zoo)
    result = partition(
        graph, PartitionSpec(algo=name, k=K, balance_mode="edge",
                             order="random", seed=0),
        device=args.device,
    )
    results[name] = result
    rep = result.quality()  # lazily computed + cached
    cost = result.analytics(program="pagerank", iters=30, mode="model")
    print(
        f"{name:8s} edge_cut={rep['edge_cut']:.4f} cv={rep['comm_volume']:.4f} "
        f"edge_imb={rep['edge_imbalance']:.2f} "
        f"PR30_model_latency={cost['total_s']*1e3:.2f}ms"
    )

# call 2: real PageRank on the CUTTANA partition (simulated K-device layout)
sim = results["cuttana"].analytics(program="pagerank", iters=20, mode="simulated")
top = np.argsort(sim["values"])[-5:][::-1]
print(f"top-5 vertices by rank: {top.tolist()}")
print(
    f"halo messages/iter: {sim['halo_messages_per_iter']} "
    f"(= K*|V|*lambda_cv), max edges on one device: {sim['max_local_edges']}"
)

# call 3: the graph-DB workload study on the same result
db = results["cuttana"].db(hops=2, num_queries=200)
print(
    f"2-hop workload: {db['qps']:.0f} qps, p99 {db['p99_latency_ms']:.2f} ms, "
    f"{db['total_rpcs']} cross-partition RPCs"
)
