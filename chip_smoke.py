#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py           # on a machine with one CUDA card
    python3 chip_smoke.py --tiny    # CPU rehearsal at a tiny size (no result)

Phases:
  0. set-up: card name and power limit, torch/CUDA versions, kernel build
     (phase 1's graph is generated on the host while nvcc runs);
  1. the partition-score kernel against its plain PyTorch version on the card
     at the main path's shapes (C=512 chunks of the phase-2 graph at K=8 and
     K=64, the chunk holding the highest-degree vertex, the dense entry),
     exact at alpha=0 and within 1e-6 with a penalty (the hub chunk also the
     same bits twice), timed with CUDA events beside the plain version, one
     ``torch.bincount`` of keys gathered beforehand (``library_ms``) and an
     empty kernel at the same launch shape (``floor_ms``); then the stream
     row ``stream8192_k8``: all 8,192 chunks of phase 2's random order, each
     launch on its own slice of the device ids, captured in one CUDA graph
     (total, mean a launch, the slowest launch), beside the empty kernel
     captured the same way, every launch's scores equal to one plain call
     over all the rows; each row names the design (``cluster_path``); and
     the zoo's shapes: ``chunk4096_k8`` (the first 4,096 rows of the random
     order, heistream's chunk) and ``dense_sampled_s<s>x512_k8`` (the
     ``[s, 512]`` matrix a ``cuttana-batched`` run samples for the first
     chunk holding a row above 512);
  2. the main path: ``fennel`` through ``repro_torch.api.partition`` on an
     R-MAT graph of 2^22 vertices and average degree 16 (the scale of SNAP's
     soc-LiveJournal1), k=8, edge balance, random order, seed 0; every chunk
     must launch the kernel once;
  3. ``fennel`` and ``cuttana`` on web-s with device="cuda" and "cpu" give
     identical assignments and the reference's edge-cuts; ``cuttana`` on
     social-m (K' = 12,496 sub-partitions, W = 1.25 GB on the card) gives
     the reference's edge-cut;
  4. ``fennel`` on social-m under ``torch.profiler``: the card's busy time,
     its idle share, and the kernel's device time per launch;
  5. the sharded partition-score kernel against its plain version on the
     card at the parallel path's shapes (a superstep of the 2^22 graph at
     S=4 and S=8, K=8; the superstep holding the highest-degree vertex;
     K=64; the dense [S,C,D] entry with random per-shard size rows), exact
     at alpha=0 and within 1e-6 with a penalty, timed like phase 1, and the
     stream row ``superstep_stream_s4_k8`` over all 2,048 supersteps;
  6. the parallel main path: ``fennel-parallel`` through
     ``repro_torch.api.partition`` on the 2^22 graph, S=4, max_workers=0,
     k=8, edge balance, random order, seed 0; the sharded kernel must launch
     once per superstep with candidates, equal to ``kernel_calls``; the
     same spec on one host thread must give the same assignment;
  7. ``fennel-parallel``, ``cuttana-parallel`` and ``cuttana-restream`` at
     S=4 on web-s with device="cuda" and "cpu" give identical assignments
     and the reference's edge-cuts; at S=1 the parallel algorithms equal
     ``fennel``/``cuttana``; ``cuttana-parallel`` on social-m at S=4 gives
     the reference's edge-cut;
  8. ``fennel-parallel`` on social-m at S=4 under ``torch.profiler``: the
     card's busy time and idle share, beside phase 4's sequential stream;
  9. the ``ell_spmv`` gather/reduce kernel against its plain version on the
     card, on both row loaders: the analytics engine's segment entry at the
     shape of phase 2's partition (all k=8 devices' CSR rows of the 2^22
     graph in one launch) and on a 32-row batch holding the hub row; the
     ELL entry at ``tests/test_kernels.py``'s shapes and on a padded ELL
     batch holding the hub row. Min exact, sum within rtol 1e-6, the engine
     launch the same bits twice; timed like phase 1, ``library_ms`` being
     ``x.gather`` + ``scatter_reduce_`` (two calls; ``x[cols]`` + ``sum`` /
     ``amin`` for the ELL entry); each row names the kernel's design
     (``merge_path``) and its achieved GB/s over the bytes of ``bound_ms``;
 10. the analytics path: ``result.analytics(program, iters,
     mode="simulated")`` on phase 2's ``fennel`` assignment for pagerank
     (30 iterations), cc and sssp (20): one kernel launch per iteration,
     values after ``CPU_PARITY_ITERS`` (5) iterations equal to the port's
     device="cpu" run at that depth (cc/sssp exactly, pagerank within rtol
     1e-5, atol 1e-9), a second pagerank run on the
     card bit-identical, ``halo_messages_per_iter`` equal to
     ``comm_volume * k * |V|``; web-s values against the float64 oracles;
 11. pagerank on social-m (phase 3's ``cuttana`` partition) under
     ``torch.profiler``: the card's busy time and idle share, beside
     phases 4 and 8;
 12. the flash-attention kernel against its plain version on the card:
     ``tests/test_kernels.py``'s shapes in float32 and bf16 and its
     decode-offset sweep (2e-5 / 2e-2), one qwen3-8b layer at prefill (B=1,
     Hq=32, Hkv=8, T=8192, Dh=128, bf16, causal; achieved TFLOP/s) and one
     at a 32k decode step (B=32 and B=8, Tq=1, Tk=32768, q_offset=32767; B
     cut from ``decode_32k``'s 128 so the plain version's float32 K/V fit)
     on the split-KV decode variant, and 65,536 (batch, head) blocks, past
     grid y's 65,535, on the decode and the tensor-core variants;
     ``library_ms`` being ``F.scaled_dot_product_attention``; each row names
     the variant that ran, and decode rows their split count;
 13. the selective-scan kernel against its plain version on the card:
     ``tests/test_kernels.py``'s shapes in float32 and bf16 (1e-4 / 3e-2),
     one falcon-mamba-7b layer at prefill (B=1, T=8192, D=8192, N=16,
     float32; ``SCAN_LAYER_TOL``) and batch 65,536 (past grid y's cap); no
     single PyTorch call computes the scan; each row names the states a
     thread holds (``states4``) and its share of the exponentials' bound;
 14. qwen3-8b at full width and depth with seeded random weights:
     ``make_prefill_step`` at B=1, T=8192 (36 flash launches, all on the
     tensor-core variant), then ``launch.serve.serve`` at B=8, prompt 128,
     32 generated tokens (36 launches a decode step: 36 x 159, on the
     split-KV decode variant with one split), prefill logits against the
     decode path's on a 16-token prompt, and one decode step under
     ``torch.profiler``;
 15. falcon-mamba-7b the same way: prefill with 64 scan launches, serve
     with none (decode is the plain recurrence, as in the reference), and
     one prefill under ``torch.profiler``;
 16. both reduced configs in float32 with the same weights on the card and
     on the CPU: logits within 1e-4 and equal greedy tokens; for qwen3 also
     one decode step over a seeded 8,192-long cache, where the decode
     kernel splits the cache;
 17. qwen3-8b long-context decode at full width and depth, with phase 14's
     weights: B=8, a 32,768-position bf16 cache filled from a seeded
     generator, 8 ``decode_step``s from position 32,760 (36 launches a step,
     all on the split-KV decode variant), one layer's attention over that
     cache against the plain version, and one step under ``torch.profiler``
     (device busy time, idle share, attention device ms);
 18. (runs after phase 11, while the graphs are loaded) the partitioner zoo
     on web-s: each of the 16 algorithms ported after the first slices, at
     the committed rows' spec (k=8, seed 0, edge balance and random order
     where the algorithm takes them), with device="cuda" and "cpu" giving
     identical results (assignment, or the vertex-cut edge partition) equal
     to the reference's value (``WEB_S_ZOO``); the partition-score launches
     equal ``kernel_calls`` for the engine-backed ones, plus one dense-entry
     launch per chunk holding a row above ``sample_cap`` for
     ``cuttana-batched`` (counted from the graph), one dense launch a chunk
     for ``cuttana-batched-legacy``, none for the host loops; and
     ``cuttana-parallel`` at S=4 with the ``gain`` and ``completeness``
     buffers (sharded launches only);
 19. social-m: ``cuttana-buffcut`` (gain), ``cluster+cuttana``,
     ``heistream`` and ``cuttana-incremental`` (16 batches, S=1 and S=4)
     against the reference's edge cuts, launches equal to ``kernel_calls``;
     the gather entry against its plain version, timed like phase 1, on
     the chunk of the ``cluster+*`` coarse graph's random order that holds
     its longest supervertex row (``coarse_chunk512_k8``);
     ``IncrementalPartitioner`` on the churn suite's stream
     (``rmat_churn(25000, 16, seed 7, "random")``, 20 batches) against
     ``BENCH_partition.json``'s edge cut; ``heistream`` under
     ``torch.profiler`` (busy time, idle share);
 20. ``cuttana-batched`` on phase 2's 2^22 R-MAT (k=8, edge balance, random
     order, seed 0, ``sample_cap`` 512, ``use_refinement=False``): first
     on the 2^20 R-MAT, device="cuda" and "cpu" giving identical
     assignments equal to the reference's edge cut
     (``RMAT_BATCHED_EDGE_CUT``), then on 2^22 under ``torch.profiler``:
     8,192 gather launches plus one dense launch per chunk holding a row of
     degree above 512, the quality scan against a host recomputation,
     ``stream_seconds`` and the idle share;
 21. (runs after phase 20, while phase 2's graph is loaded) out-of-core
     graphs: (a) ``BENCH_partition.json``'s ``outofcore/rmat40000`` rows -
     the R-MAT of 40,000 vertices, average degree 12, seed 0, written as an
     ``.npy`` edge list and converted with ``convert_edge_list`` (1,172,517
     bytes), then ``fennel``, ``cuttana`` and ``cuttana-parallel`` S=4 (k=8,
     edge balance, random order, seed 0) resident and memory-mapped (and
     ``cuttana-parallel`` mapped with ``prefetch="off"``): the committed edge
     cuts, mapped assignments equal to resident ones, the mapped runs'
     launches on the rows entries only; (b) phase 2's 2^22 R-MAT written
     with ``convert_csr`` (v2), then a child process that only opens the
     file runs phase 2's ``fennel`` on the card: its assignment equals phase
     2's, its 8,192 launches are all on the rows entry and equal
     ``kernel_calls``, and its peak device memory is below phase 2's by at
     least the graph's device arrays (its peak RSS, ``decode_wall_s`` and
     ``prefetch_hit_rate`` logged); (c) the rows entries against their plain
     versions at the mapped shapes (``mapped_chunk512_k8``: the first chunk
     of the random order, decoded from the file and packed as the engine
     packs it; ``mapped_superstep_s4x512_k8``: the first superstep at S=4),
     exact at alpha=0 and within 1e-6 with a penalty, timed like phase 1,
     with the packed buffer's bytes and its host-to-device copy time;
 22. (runs after phase 21, while phase 2's graph and partition are loaded)
     the graph-DB study and partition-aware serving, fed by partitions made
     on the card: (a) ``benchmarks/serving.py``'s recipe with the port (the
     R-MAT of 8,000 vertices, degree 12, seed 0; ``cuttana``, ``fennel``,
     ``hdrf`` and ``random`` at k=8; 2,000 queries of the default mix
     seeded 1 at concurrency 1,000): every field of the six committed
     ``serving/rmat8000/*`` rows of ``BENCH_partition.json`` but
     ``qps_wall`` (``SERVING_ROWS``), gather launches equal to
     ``kernel_calls`` (none for the host-placed ``cuttana``, ``hdrf`` and
     ``random``), ``qps_wall`` logged; the gather entry against its plain
     version on the first chunk of that cuttana stream
     (``serving_rmat8000_chunk512_k8``), timed like phase 1; (b) phase 2's
     2^22 ``fennel`` partition served at replication budget 0.05 with
     ``SERVING_QUERIES`` (1,000) queries (seed 1) at concurrency 1,000, at
     auto workers and at one worker: the same answers per query and the
     same sim metrics and counters, the answers equal to the
     ``QueryEngine``'s, the plan's and runs' seconds logged, and
     ``result.db(hops=1|2)`` with 256 queries;
     (c) ``python -m repro_torch.api.cli`` in child processes on the card:
     ``partition`` (cuttana, ``--with-db``) gives (a)'s quality and
     ``kernel_calls`` (0: cuttana places every vertex on the host),
     ``serve-bench`` (cuttana, 2,000 queries seeded 1, concurrency 1,000)
     the committed ``qps_sim`` and RPCs; ``partition`` on fennel, run in
     this process, gives (a)'s quality and launches the kernel once per
     ``kernel_calls`` (16).

Kernel times: ``ms`` is device time per launch (launches captured in a CUDA
graph and replayed, so the host's cost of a call is out); ``call_ms``,
``plain_ms`` and ``library_ms`` are per call back to back on the stream, host
cost included (the plain versions and ``torch.bincount`` synchronise, so they
cannot be captured). ``bound_ms`` is the larger of the bytes the function
must move over 3.35 TB/s and its operations over the card's peak rate.

The last lines are the ``{"kernels": [...]}`` summary, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line. Without a CUDA device (and without ``--tiny``)
the script exits 2 and prints no result. ``--tiny`` runs phases 12-17 at
the reduced configs and small kernel shapes, phase 19 on social-s (its
constants unchecked), phase 20 on the 2^12 and 2^14 graphs, phase 21's
full-size part on a 2^12 R-MAT, and phase 22(b) on phase 2's 2^14
partition (phase 22's committed rows and the CLI run unchanged, on the
CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/partition_score/csrc/partition_score.cu"
# the design of csrc/partition_score.cu, named in phases 1-2, 4-6 and 8
SCORE_VARIANT = "cluster_path"
TPU_KERNEL = "src/repro/kernels/partition_score/partition_score.py:105"
TPU_KERNEL_SHARDED = "src/repro/kernels/partition_score/partition_score.py:68"
SPMV_SOURCE = "src/repro_torch/kernels/ell_spmv/csrc/ell_spmv.cu"
TPU_KERNEL_SPMV = "src/repro/kernels/ell_spmv/ell_spmv.py:33"
SPMV_VARIANT = "merge_path"  # the design of csrc/ell_spmv.cu, named in phase 9's rows
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
TPU_KERNEL_FLASH = "src/repro/kernels/flash_attention/flash_attention.py:89"
SCAN_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
TPU_KERNEL_SCAN = "src/repro/kernels/mamba_scan/mamba_scan.py:46"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
FP64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# exponentials on the special-function units: 16 per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock behind the 67 TFLOP/s
EXP_PER_S = 132 * 16 * 1.98e9
ANALYTICS_ITERS = {"pagerank": 30, "cc": 20, "sssp": 20}  # benchmarks/analytics.py
# phase 10 holds the card's values against the CPU run after this many
# iterations of each program (the CPU run at full depth took 110-130 s of
# the smoke's time limit)
CPU_PARITY_ITERS = 5
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py's
# an attention output row is a softmax average over up to 32768 keys, so its
# entries are ~sqrt(e / keys) in size, at or below the bf16 allowance above;
# every (batch, head, query) row is also held to a relative L2 error scaled to
# its own data. Kernel and plain version both keep float32 statistics and
# round the output once to its dtype, <= 2^-8 relative per entry; the bf16
# tensor-core variant also rounds each key weight P to bf16 before P V, one
# more <= 2^-9 relative error per weight that averages down over a row (its
# worst row at the qwen3 prefill layer is 4.4e-3 on an H100). A fault such
# as skipping the last 64-key tile at the 32k decode shape keeps every entry
# within the elementwise rule but not its rows within this one.
FLASH_ROW_RTOL = 1e-2
SCAN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # tests/test_kernels.py's
# one falcon-mamba-7b layer at T=8192 in float32: the kernel rounds in
# another order (exp2 of dt * (A log2 e) by ex2.approx, within 2 ulp; fused
# multiply-adds; h.C summed over a thread's states, then over the warps),
# and the state carries each rounding over its decay horizon, about
# 1/(dt*|A|) <= 100 steps at dt >= 0.01 and |A| >= 1; the test shapes' 1e-4
# covers 8-32 steps
SCAN_LAYER_TOL = 1e-3
LM_ARCHS = ("qwen3-8b", "falcon-mamba-7b")
CHUNK = 512
NUM_SHARDS = 4
# the reference's values for these specs (repro.api.partition, k=8, edge
# balance, random order, seed 0; the parallel algorithms with num_shards=4)
WEB_S_EDGE_CUT = {
    "fennel": 0.6510985792934956,
    "cuttana": 0.5606603189477736,
    "fennel-parallel": 0.6862229956993926,
    "cuttana-parallel": 0.6669873993875399,
    "cuttana-restream": 0.3857912615672953,
}
# BENCH_partition.json's outofcore/rmat40000 rows (phase 21): the converted
# file's bytes and the edge cuts, resident and mapped alike
OUTOFCORE_FILE_BYTES = 1_172_517
OUTOFCORE_EDGE_CUT = {
    "fennel": 0.7964539101261845,
    "cuttana": 0.7836849769185488,
    "cuttana-parallel": 0.7905363837141883,
}
SOCIAL_M_CUTTANA_EDGE_CUT = 0.8217978285092379
SOCIAL_M_CUTTANA_PARALLEL_EDGE_CUT = 0.7972897394038334
# the reference's values for the zoo (repro.api.partition on web-s, the spec
# of the committed quality rows: k=8, seed 0, edge balance and random order
# where the algorithm takes them): edge cut, or (replication factor, edge
# imbalance) for the vertex-cut algorithms
WEB_S_ZOO = {
    "chunked": 0.2763935139476899,
    "cluster+cuttana": 0.5425709934905203,
    "cluster+fennel": 0.6345822386586121,
    "cuttana-batched": 0.6185177128131327,
    "cuttana-batched-legacy": 0.6185177128131327,
    "cuttana-buffcut": 0.5029367961311267,
    "cuttana-incremental": 0.6459361769775264,
    "cuttana-legacy": 0.5606603189477736,
    "fennel-legacy": 0.6510985792934956,
    "ginger": [3.911, 1.0499506350507872],
    "hash": 0.8749477066215967,
    "hdrf": [5.541, 1.000016733881089],
    "heistream": 0.6341471577502971,
    "heistream-legacy": 0.6341471577502971,
    "ldg-legacy": 0.651299385866564,
    "random": 0.8755250255191687,
}
# cuttana-parallel at S=4 by buffer strategy
WEB_S_ZOO_PARALLEL = {"gain": 0.624131929918506, "completeness": 0.6729948626985056}
# social-m, the same spec; keys are algo/num_shards
SOCIAL_M_ZOO_SPECS = (
    ("cuttana-buffcut", {"strategy": "gain"}),
    ("cluster+cuttana", {}),
    ("heistream", {}),
    ("cuttana-incremental", {"num_batches": 16}),
    ("cuttana-incremental", {"num_batches": 16, "num_shards": NUM_SHARDS}),
)
SOCIAL_M_ZOO = {
    "cuttana-buffcut/1": 0.8243048897411314,
    "cluster+cuttana/1": 0.8247421678629733,
    "heistream/1": 0.8393051488689073,
    "cuttana-incremental/1": 0.7922356680745942,
    "cuttana-incremental/4": 0.7946412375942578,
}
# BENCH_partition.json churn/rmat25000/incremental
CHURN_EDGE_CUT = 0.7724772058256066
# the reference's edge cut of phase 20's spec (cuttana-batched, k=8, edge
# balance, random order, seed 0, sample_cap 512, use_refinement=False) on
# the R-MAT of 2^scale vertices, average degree 16, seed 0, for the scales
# phase 20 checks (a quarter of its graph: 2^20 on the card, 2^12 with --tiny)
RMAT_BATCHED_EDGE_CUT = {20: 0.8362624552954572, 12: 0.7886621145043896}
# phase 22(b)'s queries on the 2^22 partition: 2,000 took 71.5 s at one
# worker on the card's host, above the 60 s a run may take in the smoke
SERVING_QUERIES = 1000
# BENCH_partition.json's serving/rmat8000/* rows (phase 22; benchmarks/
# serving.py: R-MAT 8000, degree 12, seed 0, k=8, 2,000 queries seeded 1 at
# concurrency 1,000), every field but qps_wall (the host's clock)
SERVING_ALGOS = ("cuttana", "fennel", "hdrf", "random")
SERVING_ROWS = {
    "serving/rmat8000/cuttana": {
        "algo": "cuttana", "bench": "serving/rmat8000/cuttana",
        "communication_volume": 0.252890625, "concurrency": 1000,
        "edge_cut": 0.771688622754491, "local_queries": 449, "messages": 28618,
        "num_queries": 2000, "p50_sim_ms": 0.20871840000000003,
        "p99_sim_ms": 0.9992079999999999, "qps_sim": 37263.08095863419, "rpcs": 14309,
        "wire_bytes": 54748496},
    "serving/rmat8000/fennel": {
        "algo": "fennel", "bench": "serving/rmat8000/fennel",
        "communication_volume": 0.256125, "concurrency": 1000,
        "edge_cut": 0.7868502994011976, "local_queries": 447, "messages": 28740,
        "num_queries": 2000, "p50_sim_ms": 0.2089012, "p99_sim_ms": 0.9924368,
        "qps_sim": 32496.31576269672, "rpcs": 14370, "wire_bytes": 54711888},
    "serving/rmat8000/hdrf": {
        "algo": "hdrf", "bench": "serving/rmat8000/hdrf",
        "communication_volume": 0.275453125, "concurrency": 1000,
        "edge_cut": 0.8608383233532935, "local_queries": 443, "messages": 28966,
        "num_queries": 2000, "p50_sim_ms": 0.2092504, "p99_sim_ms": 1.001914496,
        "qps_sim": 28558.3295999981, "rpcs": 14483, "wire_bytes": 55904016},
    "serving/rmat8000/random": {
        "algo": "random", "bench": "serving/rmat8000/random",
        "communication_volume": 0.2843125, "concurrency": 1000,
        "edge_cut": 0.8773652694610778, "local_queries": 436, "messages": 29256,
        "num_queries": 2000, "p50_sim_ms": 0.21794760000000002,
        "p99_sim_ms": 0.99607524, "qps_sim": 33467.25411246957, "rpcs": 14628,
        "wire_bytes": 56551816},
    "serving/rmat8000/cuttana/replication": {
        "algo": "cuttana", "answers_identical": True,
        "bench": "serving/rmat8000/cuttana/replication",
        "replication_adjacency_entries": 125160, "replication_budget": 0.05,
        "replication_budget_pairs": 400, "replication_demand_covered": 15802,
        "replication_num_replicas": 400, "rpc_reduction": 0.04881656804733725,
        "rpcs_base": 3380, "rpcs_replicated": 3215},
    "serving/rmat8000/ordering": {
        "bench": "serving/rmat8000/ordering", "p99_cuttana_over_fennel": 1.006822802217733,
        "p99_cuttana_over_hdrf": 0.9972986756746156,
        "qps_cuttana_over_random": 1.1134191300370333, "tail_ordering_ok": True,
        "throughput_ordering_ok": True},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after a warm-up:
    CUDA events on the card, the host clock on the CPU."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device

    def __call__(self, fn, reps: int = 200, warmup: int = 10) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def device_ms(self, fn, reps: int = 100, replays: int = 5) -> float:
        """Mean device milliseconds of ``fn()``'s kernel: ``reps`` calls
        captured in one CUDA graph and replayed, so the host's cost of a call
        (the Python wrapper, the launch) is out of the measurement. On the
        CPU it is the host time of a call."""
        torch = self.torch
        if self.device.type != "cuda":
            return self(fn, reps=reps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * reps)


def floor_ms(torch, timer, floor, num_rows: int, k: int, width=None):
    """Device ms of the empty kernel at the kernel's launch shape for
    ``num_rows`` rows at ``k`` (None on the CPU)."""
    if floor is None:
        return None
    import kernel_ablation_partition_score as ablation

    return timer.device_ms(ablation.floor_call(torch, floor, ablation.launch_shape(num_rows, k, width)))


def split_stats(np, ops, degrees, k: int, width=None) -> dict:
    """The kernel's split of one call (``ops.tile_plan``): its blocks and the
    rows whose items lie in more than one block."""
    plan = ops.tile_plan(np.asarray(degrees), k, width)
    return {"blocks": plan["blocks"], "split_rows": int(plan["split"].sum())}


def gather_row(torch, np, ops, ref, dgraph, graph, device, timer, floor, rng, name, batch, k):
    """One gather-entry row: the kernel on ``batch``'s rows of ``dgraph`` at
    ``k`` (a seeded ``part_of``, 30 % unassigned) against its plain version,
    exact at alpha=0 and within 1e-6 with a penalty, timed."""
    n = graph.num_vertices
    part_np = rng.integers(0, k, size=n).astype(np.int32)
    part_np[rng.random(n) < 0.3] = -1
    part_of = torch.from_numpy(part_np).to(device)
    b = torch.from_numpy(batch.astype(np.int64)).to(device)
    zeros = torch.zeros(k, dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random(k) * 100).astype(np.float32)).to(device)
    args = (dgraph.indptr, dgraph.indices, part_of, b)
    got0 = ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)
    want0 = ref.fennel_scores_gather_ref(*args, zeros, 0.0, 1.5)
    got1 = ops.fennel_scores_gather(*args, sizes, 0.37, 1.5)
    want1 = ref.fennel_scores_gather_ref(*args, sizes, 0.37, 1.5)
    sync(torch, device)
    err0 = float((got0 - want0).abs().max())
    err1 = float((got1 - want1).abs().max())
    check(err0 == 0.0, f"{name}: kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"{name}: kernel differs from plain version with penalty ({err1})")
    if "hub" in name:
        check(torch.equal(got0, ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)),
              f"{name}: two launches differ")
    rows, pos = ref.expand_rows(dgraph.indptr, b)
    parts = part_of[dgraph.indices[pos].long()]
    keep = parts >= 0
    keys = rows[keep] * k + parts[keep].long()
    nnz = int(rows.shape[0])
    c = int(b.shape[0])
    # each input read once, the output written once: the batch, two
    # indptr entries per row, the row's indices, one part_of gather per
    # entry, the size row; C*K float32 scores out
    nbytes = c * 8 + 2 * c * 8 + nnz * 4 + nnz * 4 + k * 4 + c * k * 4
    return {
        "shape": name, "variant": SCORE_VARIANT, "rows": c, "k": k, "nnz": nnz,
        "max_row": int(graph.degrees[batch].max()),
        **split_stats(np, ops, graph.degrees[batch], k),
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "ms": timer.device_ms(lambda: ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)),
        "call_ms": timer(lambda: ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)),
        "plain_ms": timer(lambda: ref.fennel_scores_gather_ref(*args, zeros, 0.0, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=c * k)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "floor_ms": floor_ms(torch, timer, floor, c, k),
    }


def dense_row(torch, np, ops, ref, device, timer, floor, rng, name, nbr_np, k):
    """One dense-entry row: the kernel on the int32 ``[B, D]`` matrix
    ``nbr_np`` at ``k`` against its plain version, exact at alpha=0 and
    within 1e-6 with a penalty, timed."""
    bsz, d = nbr_np.shape
    nbr = torch.from_numpy(nbr_np).to(device)
    zeros = torch.zeros(k, dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random(k) * 100).astype(np.float32)).to(device)
    err0 = float((ops.fennel_scores(nbr, zeros, 0.0) - ref.fennel_scores_ref(nbr, zeros, 0.0, 1.5)).abs().max())
    err1 = float((ops.fennel_scores(nbr, sizes, 0.37, 1.5) - ref.fennel_scores_ref(nbr, sizes, 0.37, 1.5)).abs().max())
    check(err0 == 0.0, f"{name}: kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"{name}: kernel differs from plain version with penalty ({err1})")
    flat = nbr.reshape(-1).long()
    keep = flat >= 0
    keys = (torch.arange(bsz, device=device).repeat_interleave(d)[keep] * k + flat[keep])
    return {
        "shape": name, "variant": SCORE_VARIANT, "rows": bsz, "k": k,
        "nnz": bsz * d, **split_stats(np, ops, np.full(bsz, d), k, d),
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "ms": timer.device_ms(lambda: ops.fennel_scores(nbr, sizes, 0.37, 1.5)),
        "call_ms": timer(lambda: ops.fennel_scores(nbr, sizes, 0.37, 1.5)),
        "plain_ms": timer(lambda: ref.fennel_scores_ref(nbr, sizes, 0.37, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=bsz * k)),
        "bound_ms": (bsz * d * 4 + k * 4 + bsz * k * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "floor_ms": floor_ms(torch, timer, floor, bsz, k, d),
    }


def sampled_matrix(np, graph, rng, k: int, sample_cap: int = 512) -> np.ndarray:
    """The ``[s, width]`` matrix a ``cuttana-batched`` run sends through the
    dense entry for the first chunk of the random order holding a row above
    ``sample_cap``: each such row's ``sample_cap`` neighbours drawn without
    replacement (from ``default_rng(0)``, in row order, as the engine draws
    them), their parts under a seeded ``part_of`` (30 % unassigned), padded
    with -1 to ``width``, a power of two of at least 8."""
    from repro_torch.graph.stream import stream_order

    ids = stream_order(graph, "random", 0)
    first = int(np.flatnonzero(graph.degrees[ids] > sample_cap)[0]) // CHUNK
    batch = ids[first * CHUNK : (first + 1) * CHUNK]
    over = batch[graph.degrees[batch] > sample_cap]
    n = graph.num_vertices
    part_np = rng.integers(0, k, size=n).astype(np.int32)
    part_np[rng.random(n) < 0.3] = -1
    width = max(8, 1 << (sample_cap - 1).bit_length())
    out = np.full((over.size, width), -1, dtype=np.int32)
    draw = np.random.default_rng(0)
    indptr, indices = graph.indptr, graph.indices
    for j, v in enumerate(over.tolist()):
        nb = indices[indptr[v] : indptr[v + 1]]
        out[j, :sample_cap] = part_np[nb[draw.choice(nb.size, size=sample_cap, replace=False)]]
    return out


def kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor):
    """Phase 1: kernel vs plain version at the main path's shapes."""
    rng = np.random.default_rng(0)
    order = rng.permutation(graph.num_vertices)
    hub = int(graph.degrees.argmax())
    gather_shapes = [
        ("chunk512_k8", order[:CHUNK], 8),
        ("chunk512_k64", order[CHUNK : 2 * CHUNK], 64),
        ("chunk512_hub_k8", np.concatenate([[hub], order[2 * CHUNK : 3 * CHUNK - 1]]), 8),
    ]
    rows_out = [gather_row(torch, np, ops, ref, dgraph, graph, device, timer, floor, rng,
                           name, batch, k) for name, batch, k in gather_shapes]
    # the dense entry (the JAX signature)
    rows_out.append(dense_row(torch, np, ops, ref, device, timer, floor, rng, "dense200x100_k16",
                              rng.integers(-1, 16, size=(200, 100)).astype(np.int32), 16))
    # the zoo's shapes (phases 18-20): heistream's 4,096-row chunks and the
    # sampled rows of cuttana-batched (sample_cap 512, so width 512)
    zoo_rng = np.random.default_rng(1)
    rows_out.append(gather_row(torch, np, ops, ref, dgraph, graph, device, timer, floor, zoo_rng,
                               "chunk4096_k8", order[: 8 * CHUNK], 8))
    sampled = sampled_matrix(np, graph, zoo_rng, 8)
    rows_out.append(dense_row(torch, np, ops, ref, device, timer, floor, zoo_rng,
                              f"dense_sampled_s{sampled.shape[0]}x512_k8", sampled, 8))
    rows_out.append(stream_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor,
                                  sharded=False))
    for row in rows_out:
        log(json.dumps({"phase": 1, **row}))
    return rows_out


def stream_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor, sharded: bool):
    """The stream rows of phases 1 and 5: every chunk of phase 2's random
    order (every superstep of phase 6's at S=4, shard after shard), each
    launch on its own slice of one device tensor of row ids, at alpha=0 as
    the engines score, captured in one CUDA graph (on the CPU: called in
    turn): total, mean and slowest launch, beside the empty kernel at each
    launch's shape captured the same way. L2 holds little of a launch's rows
    here, unlike a replay of one chunk. All launches' scores together must
    equal one plain call over all the rows (``plain_ms``)."""
    import kernel_ablation_partition_score as ablation
    from repro_torch.graph.stream import ShardedStream, stream_order

    n, k = graph.num_vertices, 8
    ids = stream_order(graph, "random", 0)
    if sharded:
        shards = ShardedStream.from_ids(ids, NUM_SHARDS)
        steps = [[sh[t * CHUNK : (t + 1) * CHUNK] for sh in shards.shards]
                 for t in range(shards.num_supersteps(CHUNK))]
        flat = np.concatenate([np.concatenate(bs) for bs in steps])
        counts = [[b.shape[0] for b in bs] for bs in steps]
        bounds = np.cumsum([0] + [sum(c) for c in counts]).tolist()
        starts = torch.from_numpy(np.array([np.concatenate([[0], np.cumsum(c)]) for c in counts],
                                           dtype=np.int64)).to(device)
        sizes = torch.zeros((NUM_SHARDS, k), dtype=torch.float32, device=device)
        name = f"superstep_stream_s{NUM_SHARDS}_k{k}"
    else:
        flat = ids
        bounds = list(range(0, n, CHUNK)) + [n]
        sizes = torch.zeros(k, dtype=torch.float32, device=device)
        name = f"stream{len(bounds) - 1}_k{k}"
    launches = len(bounds) - 1
    rng = np.random.default_rng(7)
    part_np = rng.integers(0, k, size=n).astype(np.int32)
    part_np[rng.random(n) < 0.3] = -1
    part_of = torch.from_numpy(part_np).to(device)
    b_dev = torch.from_numpy(flat.astype(np.int64)).to(device)
    args = (dgraph.indptr, dgraph.indices, part_of)

    def call(i):
        b = b_dev[bounds[i] : bounds[i + 1]]
        if sharded:
            return ops.fennel_scores_sharded_gather(*args, b, starts[i], sizes, 0.0, 1.5)
        return ops.fennel_scores_gather(*args, b, sizes, 0.0, 1.5)

    calls = [lambda i=i: call(i) for i in range(launches)]
    if device.type == "cuda":
        times, outs = ablation.stream_times(torch, calls)
        empty = ablation.stream_times(torch, [ablation.floor_call(
            torch, floor, ablation.launch_shape(bounds[i + 1] - bounds[i], k))
            for i in range(launches)])[0]
    else:
        t0 = time.perf_counter()
        outs = [c() for c in calls]
        total = (time.perf_counter() - t0) * 1e3
        times = {"total_ms": total, "mean_ms": total / launches, "slowest_ms": None,
                 "slowest": None}
        empty = {"total_ms": None, "mean_ms": None}
    got = torch.cat(outs)
    zeros = torch.zeros(k, dtype=torch.float32, device=device)
    want = ref.fennel_scores_gather_ref(*args, b_dev, zeros, 0.0, 1.5)
    if device.type == "cuda":
        torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err == 0.0, f"{name}: the stream's scores differ from the plain version ({err})")
    del got, outs, want
    degrees = graph.degrees[flat]
    nnz = int(degrees.sum())
    rows, pos = ref.expand_rows(dgraph.indptr, b_dev)
    parts = part_of[dgraph.indices[pos].long()]
    keep = parts >= 0
    keys = rows[keep] * k + parts[keep].long()
    del rows, pos, parts, keep
    # each launch reads its ids, two indptr entries a row, its rows' indices,
    # one part_of gather an entry, its size rows (and shard bounds), and
    # writes its scores
    nbytes = (24 * n + 8 * nnz + 4 * n * k
              + launches * (k * 4 if not sharded else NUM_SHARDS * k * 4 + (NUM_SHARDS + 1) * 8))
    slow = times["slowest"]
    slow_deg = degrees[bounds[slow] : bounds[slow + 1]] if slow is not None else None
    row = {
        "shape": name, "variant": SCORE_VARIANT, "launches": launches, "rows": n, "k": k,
        "nnz": nnz, "max_abs_err_alpha0": err, "ms": times["mean_ms"],
        "total_ms": times["total_ms"], "slowest_ms": times["slowest_ms"], "slowest_launch": slow,
        "slowest_launch_nnz": int(slow_deg.sum()) if slow is not None else None,
        "slowest_launch_max_degree": int(slow_deg.max()) if slow is not None else None,
        "floor_ms": empty["mean_ms"], "floor_total_ms": empty["total_ms"],
        # one call each (the plain version takes seconds at this size; the
        # check above has warmed it up)
        "plain_ms": timer(lambda: ref.fennel_scores_gather_ref(*args, b_dev, zeros, 0.0, 1.5),
                          reps=1, warmup=0),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=n * k), reps=1, warmup=1),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    del keys
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def profile_stream(torch, tapi, graph, device, algo="fennel", params=None) -> dict:
    """Phases 4 and 8: ``algo`` on ``graph`` under ``torch.profiler``: how
    much of the run the card is busy, and with what. Device events are summed
    by name (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                              params=params)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = tapi.partition(graph, spec, device=device)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {
        "algo": algo, "params": params, "num_vertices": graph.num_vertices,
        "kernel_calls": res.telemetry["kernel_calls"], "variant": SCORE_VARIANT,
        "profiled_wall_s": wall, "stream_seconds": res.timings["stream_seconds"],
        **device_time(prof, wall, on_card, "score_path_kernel"),
    }


def device_time(prof, wall: float, on_card: bool, kernel_name: str) -> dict:
    """The card's busy time and idle share over a profiled window of
    ``wall`` seconds, and the device time of the kernels whose name holds
    ``kernel_name``. Device events are summed by name (one stream, so they
    do not overlap); user annotations such as a schedule's ``ProfilerStep#``
    span the window on the device's timeline and are no device work."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}
    for e in prof.events():
        annotation = getattr(e, "is_user_annotation", False) or e.name.startswith("ProfilerStep")
        if e.device_type == DeviceType.CUDA and not annotation:
            slot = by_name.setdefault(e.name, [0.0, 0])
            slot[0] += e.time_range.elapsed_us()
            slot[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    kernel = [v for k, v in by_name.items() if kernel_name in k]
    kernel_us = sum(us for us, _ in kernel)
    kernel_n = sum(n for _, n in kernel)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "device_busy_s": busy_us / 1e6 if on_card else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if on_card else None,
        "kernel_events": kernel_n if on_card else None,
        "kernel_device_ms_total": kernel_us / 1e3 if on_card else None,
        "kernel_device_ms_per_launch": kernel_us / 1e3 / kernel_n if kernel_n else None,
        "top_device_events_ms": [[k[:80], us / 1e3, n] for k, (us, n) in top],
    }


def profile_analytics(torch, res, spmv, device, iters: int = 30) -> dict:
    """Phase 11: ``res.analytics("pagerank", iters)`` under
    ``torch.profiler``: how much of the run the card is busy. The run is
    about 10 ms, and a window that short loses the device events of its
    first milliseconds, so one run warms the profiler up and the next one
    is recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            spmv.launches = 0
            t0 = time.perf_counter()
            out = res.analytics("pagerank", iters, mode="simulated")
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    return {
        "program": "pagerank", "iters": iters, "num_vertices": res.graph.num_vertices,
        "algo": res.spec.algo, "profiled_wall_s": wall, "seconds": out["seconds"],
        "launches": spmv.launches, **device_time(prof, wall, on_card, "spmv_kernel"),
    }


def sharded_kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor):
    """Phase 5: the sharded kernel vs its plain version at the parallel
    path's shapes: superstep batches of the random stream order (seed 0),
    shard after shard, as ``_SuperstepRunner`` packs them."""
    from repro_torch.graph.stream import ShardedStream, stream_order

    rng = np.random.default_rng(5)
    n = graph.num_vertices
    ids = stream_order(graph, "random", 0)
    hub = int(graph.degrees.argmax())
    s4 = ShardedStream.from_ids(ids, NUM_SHARDS)
    hub_shard = int(np.flatnonzero(ids == hub)[0]) % NUM_SHARDS
    t_hub = int(np.flatnonzero(s4.shards[hub_shard] == hub)[0]) // CHUNK
    cases = [
        (f"superstep_s{NUM_SHARDS}_k8", s4, 0, 8),
        ("superstep_s8_k8", ShardedStream.from_ids(ids, 8), 0, 8),
        (f"superstep_hub_s{NUM_SHARDS}_k8", s4, t_hub, 8),
        (f"superstep_s{NUM_SHARDS}_k64", s4, 1, 64),
    ]
    rows_out = []
    for name, sharded, step, k in cases:
        batches = [sh[step * CHUNK : (step + 1) * CHUNK] for sh in sharded.shards]
        counts = [b.shape[0] for b in batches]
        s = len(batches)
        part_np = rng.integers(0, k, size=n).astype(np.int32)
        part_np[rng.random(n) < 0.3] = -1
        part_of = torch.from_numpy(part_np).to(device)
        b = torch.from_numpy(np.concatenate(batches).astype(np.int64)).to(device)
        start = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)).to(device)
        zeros = torch.zeros((s, k), dtype=torch.float32, device=device)
        sizes = torch.from_numpy((rng.random((s, k)) * 100).astype(np.float32)).to(device)
        args = (dgraph.indptr, dgraph.indices, part_of, b, start)
        got0 = ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)
        want0 = ref.fennel_scores_sharded_gather_ref(*args, zeros, 0.0, 1.5)
        got1 = ops.fennel_scores_sharded_gather(*args, sizes, 0.37, 1.5)
        want1 = ref.fennel_scores_sharded_gather_ref(*args, sizes, 0.37, 1.5)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err0 = float((got0 - want0).abs().max())
        err1 = float((got1 - want1).abs().max())
        check(err0 == 0.0, f"{name}: sharded kernel differs from plain version at alpha=0 ({err0})")
        check(err1 <= 1e-6, f"{name}: sharded kernel differs from plain version with penalty ({err1})")
        if "hub" in name:
            check(torch.equal(got0, ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)),
                  f"{name}: two launches differ")
        rows, pos = ref.expand_rows(dgraph.indptr, b)
        parts = part_of[dgraph.indices[pos].long()]
        keep = parts >= 0
        keys = rows[keep] * k + parts[keep].long()
        nnz = int(rows.shape[0])
        c = int(b.shape[0])
        # each input read once, the output written once: the candidates, two
        # indptr entries per row, the rows' indices, one part_of gather per
        # entry, the shard bounds and size rows; C*K float32 scores out
        nbytes = c * 8 + 2 * c * 8 + nnz * 4 + nnz * 4 + (s + 1) * 8 + s * k * 4 + c * k * 4
        rows_out.append({
            "shape": name, "variant": SCORE_VARIANT, "shards": s, "superstep": step, "rows": c,
            "k": k, "nnz": nnz, **split_stats(np, ops, graph.degrees[np.concatenate(batches)], k),
            "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
            "ms": timer.device_ms(lambda: ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)),
            "call_ms": timer(lambda: ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)),
            "plain_ms": timer(lambda: ref.fennel_scores_sharded_gather_ref(*args, zeros, 0.0, 1.5)),
            "library_ms": timer(lambda: torch.bincount(keys, minlength=c * k)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "floor_ms": floor_ms(torch, timer, floor, c, k),
        })
    # the dense entry (the JAX signature) with random per-shard size rows
    s, c, d, k = NUM_SHARDS, CHUNK, 64, 8
    nbr = torch.from_numpy(rng.integers(-1, k, size=(s, c, d)).astype(np.int32)).to(device)
    zeros = torch.zeros((s, k), dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random((s, k)) * 100).astype(np.float32)).to(device)
    err0 = float((ops.fennel_scores_sharded(nbr, zeros, 0.0)
                  - ref.fennel_scores_sharded_ref(nbr, zeros, 0.0, 1.5)).abs().max())
    err1 = float((ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)
                  - ref.fennel_scores_sharded_ref(nbr, sizes, 0.37, 1.5)).abs().max())
    check(err0 == 0.0, f"sharded dense: kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"sharded dense: kernel differs from plain version with penalty ({err1})")
    flat = nbr.reshape(-1).long()
    keep = flat >= 0
    keys = torch.arange(s * c, device=device).repeat_interleave(d)[keep] * k + flat[keep]
    rows_out.append({
        "shape": f"dense{s}x{c}x{d}_k{k}", "variant": SCORE_VARIANT, "shards": s, "rows": s * c,
        "k": k, "nnz": s * c * d, **split_stats(np, ops, np.full(s * c, d), k, d),
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "ms": timer.device_ms(lambda: ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)),
        "call_ms": timer(lambda: ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)),
        "plain_ms": timer(lambda: ref.fennel_scores_sharded_ref(nbr, sizes, 0.37, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=s * c * k)),
        "bound_ms": (s * c * d * 4 + s * k * 4 + s * c * k * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "floor_ms": floor_ms(torch, timer, floor, s * c, k, d),
    })
    rows_out.append(stream_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor,
                                  sharded=True))
    for row in rows_out:
        log(json.dumps({"phase": 5, **row}))
    return rows_out


def spmv_row(torch, timer, name, entry, reduce, got, want, call, plain, library,
             nbytes: int, ops: int, reps: int = 200, **extra) -> dict:
    """One phase-9 row: the kernel against its plain version (min exactly,
    sum within rtol 1e-6), its times, and its bound."""
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / want.double().abs().clamp(min=1e-30)).max()) if diff.numel() else 0.0
    if reduce == "min":
        check(torch.equal(got, want), f"{name}: min kernel differs from plain version ({err})")
    else:
        check(bool((diff <= 1e-6 * want.double().abs()).all()),
              f"{name}: sum kernel differs from plain version beyond rtol 1e-6 ({rel})")
    rate = FP64_OPS_PER_S if reduce == "sum" else FP32_OPS_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    ms = timer.device_ms(call)
    return {
        "shape": name, "entry": entry, "reduce": reduce, "variant": SPMV_VARIANT, **extra,
        "max_abs_err": err, "max_rel_err": rel,
        "ms": ms, "gb_per_s": nbytes / ms / 1e6,
        "call_ms": timer(call, reps=reps),
        "plain_ms": timer(plain, reps=reps),
        "library_ms": timer(library, reps=reps),
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def spmv_kernel_checks(torch, np, spmv, spmv_ref, lg, device, timer):
    """Phase 9: the gather/reduce kernel vs its plain version on both row
    loaders, at the analytics engine's shape for phase 2's partition."""
    rng = np.random.default_rng(9)
    dev = lg.to(device)
    k, v_max, state_len, e_max = lg.k, lg.v_max, lg.state_len, lg.e_max
    rows_out = []
    x_np = rng.random((k, state_len)).astype(np.float32)
    rows64 = torch.from_numpy(lg.rows.astype(np.int64)).to(device)
    cols64 = dev.cols.long()
    ent_rows, ent_pos = spmv_ref.segment_entries(dev.row_ptr, e_max)
    nnz = int(ent_rows.shape[0])
    # distinct source values the real entries read: the x bytes the function needs
    x_read = int(torch.unique((ent_pos // e_max) * state_len + dev.cols.reshape(-1)[ent_pos]).shape[0])
    del ent_rows, ent_pos
    degs = (dev.row_ptr[:, 1:] - dev.row_ptr[:, :-1])
    p_hub, r_hub = divmod(int(degs.reshape(-1).argmax()), v_max)
    hub_deg = int(degs[p_hub, r_hub])
    for reduce, ident in (("sum", 0.0), ("min", 3e38)):
        x_np[:, -1] = ident
        x = torch.from_numpy(x_np).to(device)
        args = (x, dev.row_ptr, dev.cols, reduce)
        got = spmv.ell_spmv_segments(*args)
        again = spmv.ell_spmv_segments(*args)
        want = spmv_ref.ell_spmv_segments_ref(*args)
        if device.type == "cuda":
            torch.cuda.synchronize()
        check(torch.equal(got, again), f"engine {reduce}: two launches gave different bits")
        red = "sum" if reduce == "sum" else "amin"
        rows_out.append(spmv_row(
            torch, timer, f"engine_k{k}_{reduce}", "segments", reduce, got, want,
            lambda: spmv.ell_spmv_segments(*args),
            lambda: spmv_ref.ell_spmv_segments_ref(*args),
            lambda: torch.full((k, v_max + 1), ident, device=device).scatter_reduce_(
                1, rows64, x.gather(1, cols64), red, include_self=True),
            nbytes=k * (v_max + 1) * 8 + nnz * 4 + x_read * 4 + k * v_max * 4, ops=nnz,
            reps=10, rows=k * v_max, nnz=nnz, hub_degree=hub_deg, deterministic=True,
        ))
        # a 32-row batch of the hub's device holding the hub row: one warp
        # walks the hub's whole degree, the tail of the engine's launch
        r0 = max(0, min(r_hub, v_max - 32))
        rp = (dev.row_ptr[p_hub, r0 : r0 + 33] - dev.row_ptr[p_hub, r0]).reshape(1, -1).contiguous()
        lo, hi = int(dev.row_ptr[p_hub, r0]), int(dev.row_ptr[p_hub, r0 + rp.shape[1] - 1])
        hcols = dev.cols[p_hub, lo:hi].reshape(1, -1).contiguous()
        hx = x[p_hub : p_hub + 1].contiguous()
        hargs = (hx, rp, hcols, reduce)
        hrows = torch.arange(rp.shape[1] - 1, device=device).repeat_interleave(rp[0, 1:] - rp[0, :-1])
        rows_out.append(spmv_row(
            torch, timer, f"hub_batch32_{reduce}", "segments", reduce,
            spmv.ell_spmv_segments(*hargs), spmv_ref.ell_spmv_segments_ref(*hargs),
            lambda: spmv.ell_spmv_segments(*hargs),
            lambda: spmv_ref.ell_spmv_segments_ref(*hargs),
            lambda: torch.full((rp.shape[1] - 1,), ident, device=device).scatter_reduce_(
                0, hrows, hx[0][hcols[0].long()], red, include_self=True),
            nbytes=rp.numel() * 8 + hcols.numel() * 4
            + int(torch.unique(hcols).shape[0]) * 4 + (rp.shape[1] - 1) * 4,
            ops=hcols.numel(), rows=rp.shape[1] - 1, nnz=hcols.numel(), hub_degree=hub_deg,
        ))
        # the same batch as the dense ELL matrix the TPU kernel needs: every
        # row padded to the hub's degree with the identity slot
        ell = torch.full((rp.shape[1] - 1, hub_deg), state_len - 1, dtype=torch.int32, device=device)
        for r in range(rp.shape[1] - 1):
            a, b = int(rp[0, r]), int(rp[0, r + 1])
            ell[r, : b - a] = hcols[0, a:b]
        xe = hx[0]
        rows_out.append(spmv_row(
            torch, timer, f"hub_ell32x{hub_deg}_{reduce}", "ell", reduce,
            spmv.ell_spmv(xe, ell, reduce), spmv_ref.ell_spmv_ref(xe, ell, reduce),
            lambda: spmv.ell_spmv(xe, ell, reduce),
            lambda: spmv_ref.ell_spmv_ref(xe, ell, reduce),
            lambda: (torch.sum if reduce == "sum" else torch.amin)(xe[ell.long()], 1),
            nbytes=ell.numel() * 4 + int(torch.unique(ell).shape[0]) * 4 + ell.shape[0] * 4,
            ops=ell.numel(), rows=ell.shape[0], nnz=ell.numel(), hub_degree=hub_deg,
        ))
        # tests/test_kernels.py's ELL shapes and inputs
        for r, d, v in ((16, 8, 64), (128, 32, 300), (333, 17, 1000)):
            trng = np.random.default_rng(r + d)
            xt = np.concatenate([trng.random(v).astype(np.float32), [ident]]).astype(np.float32)
            ct = trng.integers(0, v + 1, size=(r, d)).astype(np.int32)
            xt, ct = torch.from_numpy(xt).to(device), torch.from_numpy(ct).to(device)
            rows_out.append(spmv_row(
                torch, timer, f"ell{r}x{d}_v{v}_{reduce}", "ell", reduce,
                spmv.ell_spmv(xt, ct, reduce), spmv_ref.ell_spmv_ref(xt, ct, reduce),
                lambda: spmv.ell_spmv(xt, ct, reduce),
                lambda: spmv_ref.ell_spmv_ref(xt, ct, reduce),
                lambda: (torch.sum if reduce == "sum" else torch.amin)(xt[ct.long()], 1),
                nbytes=r * d * 4 + int(torch.unique(ct).shape[0]) * 4 + r * 4,
                ops=r * d, rows=r, nnz=r * d,
            ))
    del rows64, cols64
    for row in rows_out:
        log(json.dumps({"phase": 9, **row}))
    return rows_out


def zoo_fields(tapi, name: str, **params) -> dict:
    """Spec fields of the committed quality rows: k=8, seed 0, edge balance
    and random order where the algorithm takes them."""
    info = tapi.get_info(name)
    fields = dict(algo=name, k=8, seed=0, params=params or None)
    if info.balance_modes:
        fields["balance_mode"] = "edge"
    if "order" in info.common:
        fields["order"] = "random"
    return fields


def zoo_value(res):
    """A run's committed quality value: the edge cut of an edge-cut run,
    (replication factor, edge imbalance) of a vertex-cut run."""
    q = res.quality()
    if res.is_vertex_cut:
        return [q["replication_factor"], q["edge_imbalance"]]
    return q["edge_cut"]


def sampled_chunks(np, graph, sample_cap: int, order: str = "random", seed: int = 0,
                   chunk: int = CHUNK) -> int:
    """Chunks of the stream holding a row above ``sample_cap``: the
    dense-entry launches of a ``cuttana-batched`` run, on top of one
    gather-entry launch a chunk."""
    from repro_torch.graph.stream import stream_order

    over = graph.degrees[stream_order(graph, order, seed)] > sample_cap
    return int(np.logical_or.reduceat(over, np.arange(0, over.size, chunk)).sum())


def zoo_run(torch, np, tapi, ops, counters, graph, device, fields, expect_launches,
            cpu_too: bool = True) -> tuple:
    """One spec on ``device`` (and on the CPU): identical results, and the
    partition-score launches of the device run, sequential and sharded
    entries together, equal to ``expect_launches(result)``. Returns the
    device result, the row to log and the launch counts."""
    spec = tapi.PartitionSpec(**fields)
    reset_counts(*counters)
    on_dev = tapi.partition(graph, spec, device=device)
    sync(torch, device)
    seq, sharded = ops.launches, ops.sharded_launches
    want = expect_launches(on_dev) if device.type == "cuda" else 0
    check(seq + sharded == want,
          f"{fields['algo']}: {seq} + {sharded} partition-score launches, expected {want}")
    row = {"algo": fields["algo"], "params": fields.get("params"), "value": zoo_value(on_dev),
           "kernel_calls": on_dev.telemetry.get("kernel_calls"), "launches": seq,
           "sharded_launches": sharded, "timings_device": on_dev.timings}
    if cpu_too:
        on_cpu = tapi.partition(graph, spec, device="cpu")
        check(np.array_equal(on_dev.assignment, on_cpu.assignment),
              f"{fields['algo']}: {device.type} and cpu results differ")
        if on_dev.is_vertex_cut:
            for f in ("replicas", "masters", "edge_counts"):
                check(np.array_equal(getattr(on_dev.edge_partition, f),
                                     getattr(on_cpu.edge_partition, f)),
                      f"{fields['algo']}: {device.type} and cpu {f} differ")
        check(on_dev.quality() == on_cpu.quality(),
              f"{fields['algo']}: {device.type} and cpu quality differ")
        row.update(identical_to_cpu=True, timings_cpu=on_cpu.timings)
    return on_dev, row, (seq, sharded)


def profile_once(torch, fn, device, kernel_name: str) -> tuple:
    """One call of ``fn`` under ``torch.profiler`` (a window of seconds, so
    no warm-up call): its value and the card's busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(torch, device)
        wall = time.perf_counter() - t0
    return out, {"profiled_wall_s": wall, **device_time(prof, wall, on_card, kernel_name)}


def zoo_phases(torch, np, tapi, ops, ref, counters, device, timer, floor, web, social, graph,
               dataset: str, tiny: bool, ident: str) -> tuple:
    """Phases 18-20: the partitioner zoo on the card. Returns the launches of
    each path and the kernel rows at the zoo's own shapes, for the summary
    line."""
    from repro_torch.core.cluster import build_coarse_graph, streaming_cluster
    from repro_torch.core.incremental import IncrementalPartitioner
    from repro_torch.graph.churn import rmat_churn
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.metrics import quality_report
    from repro_torch.graph.stream import stream_order

    paths: dict = {}
    kernel_rows: list = []

    def engine_launches(res):
        return res.telemetry["kernel_calls"]

    def batched_launches(res):
        cap = res.spec.params.sample_cap
        return res.telemetry["kernel_calls"] + sampled_chunks(np, res.graph, cap)

    def legacy_batched_launches(res):
        return -(-res.graph.num_vertices // res.spec.params.chunk)

    # ----------------------------------------------------------- phase 18
    for name in sorted(WEB_S_ZOO):
        info = tapi.get_info(name)
        if name == "cuttana-batched":
            expect = batched_launches
        elif name == "cuttana-batched-legacy":
            expect = legacy_batched_launches
        elif info.engine == "engine":
            expect = engine_launches
        else:
            expect = lambda res: 0  # host loops: no partition-score launch  # noqa: E731
        res, row, launched = zoo_run(torch, np, tapi, ops, counters, web, device,
                                     zoo_fields(tapi, name), expect)
        check(row["value"] == WEB_S_ZOO[name],
              f"web-s {name}: {row['value']} != the reference's {WEB_S_ZOO[name]}")
        if name == "cuttana-batched":
            row["dense_launches"] = launched[0] - row["kernel_calls"] if device.type == "cuda" else 0
        paths[f"web-s {name}"] = launched
        log(json.dumps({"phase": 18, "dataset": "web-s", "kind": info.kind, **row}))
    for strategy in ("gain", "completeness"):
        name = f"cuttana-parallel/{strategy}"
        res, row, launched = zoo_run(
            torch, np, tapi, ops, counters, web, device,
            zoo_fields(tapi, "cuttana-parallel", num_shards=NUM_SHARDS, strategy=strategy),
            engine_launches)
        check(launched[0] == 0, f"web-s {name}: the sequential entry launched")
        check(row["value"] == WEB_S_ZOO_PARALLEL[strategy],
              f"web-s {name}: {row['value']} != the reference's {WEB_S_ZOO_PARALLEL[strategy]}")
        paths[f"web-s {name} num_shards={NUM_SHARDS}"] = launched
        log(json.dumps({"phase": 18, "dataset": "web-s", "num_shards": NUM_SHARDS, **row}))

    # ----------------------------------------------------------- phase 19
    for name, params in SOCIAL_M_ZOO_SPECS:
        res, row, launched = zoo_run(torch, np, tapi, ops, counters, social, device,
                                     zoo_fields(tapi, name, **params), engine_launches,
                                     cpu_too=False)
        key = f"{name}/{params.get('num_shards', 1)}"
        if not tiny:
            check(row["value"] == SOCIAL_M_ZOO[key],
                  f"social-m {name} {params}: {row['value']} != {SOCIAL_M_ZOO[key]}")
        paths[" ".join([dataset, name] + [f"{k}={v}" for k, v in params.items()])] = launched
        for extra in ("stream_seconds", "fm_moves", "clusters_found", "coarse_edges",
                      "prepass_seconds", "project_seconds", "restream_windows",
                      "buffer_strategy", "buffer_evictions", "refine_moves"):
            if extra in res.telemetry or extra in res.timings:
                row[extra] = res.telemetry.get(extra, res.timings.get(extra))
        log(json.dumps({"phase": 19, "dataset": dataset, **row}))
    # the gather entry on the coarse graph of cluster+* at this spec: the
    # chunk of its random order holding the longest supervertex row, which
    # the kernel splits over the blocks of its cluster
    k = 8
    ids = stream_order(social, "random", 0)
    cluster_of, num_clusters, _ = streaming_cluster(
        social, ids, max(0.1 * social.indices.shape[0] / k, 1.0),
        max(int(0.1 * social.num_vertices / k), 1), 1000)
    coarse = build_coarse_graph(social, cluster_of, num_clusters)
    cids = stream_order(coarse, "random", 0)
    at = int(np.flatnonzero(cids == int(coarse.degrees.argmax()))[0]) // CHUNK * CHUNK
    row = gather_row(torch, np, ops, ref, coarse.to(device), coarse, device, timer, floor,
                     np.random.default_rng(2), "coarse_chunk512_k8", cids[at : at + CHUNK], k)
    kernel_rows.append(row)
    log(json.dumps({"phase": 19, "dataset": dataset, "coarse_graph": "cluster+* prepass",
                    "coarse_vertices": coarse.num_vertices, **row}))
    del coarse
    # the churn suite's stream (benchmarks/churn.py): 20 arrival batches
    stream = rmat_churn(25_000, avg_degree=16, seed=7, ordering="random")
    final = stream.final_graph()
    reset_counts(*counters)
    t0 = time.perf_counter()
    inc = IncrementalPartitioner(stream.num_vertices, 8, balance_mode="edge", seed=7,
                                 device=device)
    batch_s = []
    for batch in stream.batches(20):
        t1 = time.perf_counter()
        inc.ingest(batch)
        sync(torch, device)
        batch_s.append(time.perf_counter() - t1)
    part = inc.finalize()
    stream_s = time.perf_counter() - t0
    cut = quality_report(final, part, 8, device)["edge_cut"]
    check(cut == CHURN_EDGE_CUT, f"churn incremental: edge_cut {cut} != {CHURN_EDGE_CUT}")
    want = inc.kernel_calls if device.type == "cuda" else 0
    check(ops.launches + ops.sharded_launches == want,
          f"churn incremental: {ops.launches} launches, expected {want}")
    paths["churn rmat25000 incremental"] = (ops.launches, ops.sharded_launches)
    log(json.dumps({
        "phase": 19, "stream": "rmat_churn(25000, 16, seed 7, random)", "batches": 20,
        "edge_cut": cut, "kernel_calls": inc.kernel_calls, "launches": ops.launches,
        "restream_windows": inc.restream_windows, "stream_seconds": stream_s,
        "mean_batch_ms": 1e3 * sum(batch_s) / len(batch_s), "device": ident,
    }))
    res, prof_row = profile_once(
        torch, lambda: tapi.partition(social, tapi.PartitionSpec(
            **zoo_fields(tapi, "heistream")), device=device), device, "score_path_kernel")
    log(json.dumps({"phase": 19, "dataset": dataset, "algo": "heistream", "profiled": True,
                    "kernel_calls": res.telemetry["kernel_calls"],
                    "stream_seconds": res.timings["stream_seconds"], **prof_row}))

    # ----------------------------------------------------------- phase 20
    fields = zoo_fields(tapi, "cuttana-batched", sample_cap=512, use_refinement=False)
    scale = int(np.log2(graph.num_vertices))
    # the same spec on a 4x smaller R-MAT: the card's run equals the CPU's
    # (every launch's kernel against its plain version along the path) and
    # the reference's value
    ref_scale = scale - 2
    small = rmat_graph(1 << ref_scale, avg_degree=16, seed=0)
    res, row, launched = zoo_run(
        torch, np, tapi, ops, counters, small, device, fields,
        lambda r: r.telemetry["kernel_calls"] + sampled_chunks(np, r.graph, 512))
    check(row["value"] == RMAT_BATCHED_EDGE_CUT[ref_scale],
          f"rmat 2^{ref_scale} cuttana-batched: {row['value']} != the reference's "
          f"{RMAT_BATCHED_EDGE_CUT[ref_scale]}")
    paths[f"rmat 2^{ref_scale} cuttana-batched"] = launched
    log(json.dumps({"phase": 20, "graph": f"rmat 2^{ref_scale} avg_degree 16",
                    "reference_edge_cut": RMAT_BATCHED_EDGE_CUT[ref_scale],
                    "rows_above_cap": int((small.degrees > 512).sum()),
                    "stream_seconds": res.timings["stream_seconds"], **row}))
    del small, res
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spec = tapi.PartitionSpec(**fields)
    reset_counts(*counters)
    res, prof_row = profile_once(
        torch, lambda: tapi.partition(graph, spec, device=device), device, "score_path_kernel")
    chunks = -(-graph.num_vertices // CHUNK)
    dense = sampled_chunks(np, graph, 512)
    check(res.telemetry["kernel_calls"] == chunks,
          f"cuttana-batched: kernel_calls {res.telemetry['kernel_calls']} != {chunks} chunks")
    want = chunks + dense if device.type == "cuda" else 0
    check(ops.launches == want and ops.sharded_launches == 0,
          f"cuttana-batched: {ops.launches} launches, expected {chunks} gather + {dense} dense")
    paths[f"rmat 2^{scale} cuttana-batched"] = (ops.launches, ops.sharded_launches)
    launches = ops.launches
    q = res.quality()
    check_quality(np, graph, res.assignment, q, 8, "cuttana-batched")
    log(json.dumps({
        "phase": 20, "algo": "cuttana-batched", "params": fields["params"],
        "graph": f"rmat 2^{scale} avg_degree 16", "edge_cut": q["edge_cut"],
        "edge_imbalance": q["edge_imbalance"], "kernel_calls": res.telemetry["kernel_calls"],
        "gather_launches": chunks if device.type == "cuda" else 0,
        "dense_launches": launches - chunks if device.type == "cuda" else 0,
        "rows_above_cap": int((graph.degrees > 512).sum()),
        "stream_seconds": res.timings["stream_seconds"], "total_s": res.timings["total_s"],
        "max_memory_allocated": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
        "device": ident, **prof_row,
    }))
    return paths, kernel_rows


def main_spec(tapi):
    """Phase 2's spec (the main path): ``fennel``, k=8, edge balance, random
    order, seed 0."""
    return tapi.PartitionSpec(algo="fennel", k=8, epsilon=0.05, balance_mode="edge",
                              order="random", seed=0)


def mapped_child(path: str, out: str, tiny: bool) -> int:
    """The child of phase 21(b): open the file, run phase 2's spec on it,
    save the assignment to ``out`` and print one JSON line. Its peak RSS and
    device memory are its own."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from outofcore_decode_study import PeakRss

    rss = PeakRss()
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.api as tapi
    from repro_torch.graph.external import ExternalCSRGraph
    from repro_torch.kernels.partition_score import build, ops

    device = torch.device("cpu" if tiny else "cuda")
    if device.type == "cuda":
        build.LIBRARY.load()  # built by the parent's phase 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rss_base = rss.current()  # the interpreter, torch and the CUDA runtime
    t0 = time.perf_counter()
    graph = ExternalCSRGraph(path)
    open_s = time.perf_counter() - t0
    ops.reset()
    res = tapi.partition(graph, main_spec(tapi), device=device)
    sync(torch, device)
    launches = {"rows": ops.rows_launches, "sharded_rows": ops.sharded_rows_launches,
                "gather": ops.launches, "sharded": ops.sharded_launches}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    peak_rss = rss.stop()
    t0 = time.perf_counter()
    q = res.quality()  # the range scans, a row range's rows on the card at a time
    quality_s = time.perf_counter() - t0
    np.save(out, res.assignment)
    tel = res.telemetry
    print(json.dumps({
        "open_seconds": open_s, "stream_seconds": res.timings["stream_seconds"],
        "total_s": res.timings["total_s"], "kernel_calls": tel["kernel_calls"],
        "launches": launches, "decode_wall_s": tel.get("decode_wall_s"),
        "prefetch_hit_rate": tel.get("prefetch_hit_rate"),
        "prefetch_wait_s": tel.get("prefetch_wait_s"),
        "graph_backing": tel["graph_backing"], "peak_graph_bytes": tel["peak_graph_bytes"],
        "mapped_graph_bytes": tel["mapped_graph_bytes"],
        "compressed_graph_bytes": tel["compressed_graph_bytes"],
        "max_memory_allocated": peak, "peak_rss_bytes": peak_rss, "rss_before_graph_bytes": rss_base,
        "quality": q, "quality_seconds": quality_s,
    }), flush=True)
    return 0


def rows_row(torch, np, ops, ref, device, timer, floor, rng, name, graph, batches, k):
    """One rows-entry row at a mapped shape: the rows of ``batches`` (one
    batch: a chunk; several: a superstep's shards) decoded from the mapped
    ``graph`` and packed into one host buffer as the engine packs them,
    copied to the device, the kernel against its plain version (exact at
    alpha=0, within 1e-6 with a penalty), timed like phase 1, and the copy
    timed on its own."""
    from repro_torch.core.engine import _expand_csr_batch, _pack_rows, _unpack_rows

    sharded = len(batches) > 1
    big = np.concatenate(batches).astype(np.int64)
    degs = (graph.indptr[big + 1] - graph.indptr[big]).astype(np.int64)
    _, cols = _expand_csr_batch(graph.indptr, graph.indices, big, degs)
    c, nnz, s = big.shape[0], cols.shape[0], len(batches)
    bounds = np.concatenate([[0], np.cumsum([b.shape[0] for b in batches])]).astype(np.int64)
    head = [big, bounds] if sharded else []
    h = sum(a.shape[0] for a in head)
    packed = _pack_rows(head, degs, cols, device.type == "cuda")
    dev = packed.to(device, non_blocking=True)
    local_indptr, cols_dev = _unpack_rows(dev, h, c, nnz)
    n = graph.num_vertices
    part_np = rng.integers(0, k, size=n).astype(np.int32)
    part_np[rng.random(n) < 0.3] = -1
    part_of = torch.from_numpy(part_np).to(device)
    rows_s = (s, k) if sharded else (k,)
    zeros = torch.zeros(rows_s, dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random(rows_s) * 100).astype(np.float32)).to(device)
    if sharded:
        args = (local_indptr, cols_dev, part_of, dev[c:h])
        kern, plain = ops.fennel_scores_sharded_rows, ref.fennel_scores_sharded_rows_ref
    else:
        args = (local_indptr, cols_dev, part_of)
        kern, plain = ops.fennel_scores_rows, ref.fennel_scores_rows_ref
    got0, want0 = kern(*args, zeros, 0.0, 1.5), plain(*args, zeros, 0.0, 1.5)
    got1, want1 = kern(*args, sizes, 0.37, 1.5), plain(*args, sizes, 0.37, 1.5)
    sync(torch, device)
    err0 = float((got0 - want0).abs().max())
    err1 = float((got1 - want1).abs().max())
    check(err0 == 0.0, f"{name}: rows kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"{name}: rows kernel differs from plain version with penalty ({err1})")
    rows = torch.repeat_interleave(torch.arange(c, device=device), local_indptr.diff())
    parts = part_of[cols_dev.long()]
    keep = parts >= 0
    keys = rows[keep] * k + parts[keep].long()
    # each input read once, the output written once: the local offsets, the
    # rows' neighbour ids, one part_of gather per entry, the shard bounds and
    # size rows; C*K float32 scores out
    nbytes = (c + 1) * 8 + nnz * 4 + nnz * 4 + (s + 1) * 8 * sharded + zeros.numel() * 4 + c * k * 4
    return {
        "shape": name, "variant": SCORE_VARIANT, "entry": kern.__name__, "shards": s,
        "rows": c, "k": k, "nnz": nnz, "max_row": int(degs.max()),
        **split_stats(np, ops, degs, k),
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "packed_bytes": packed.numel() * 8,
        "copy_ms": timer(lambda: packed.to(device, non_blocking=True)),
        "ms": timer.device_ms(lambda: kern(*args, zeros, 0.0, 1.5)),
        "call_ms": timer(lambda: kern(*args, zeros, 0.0, 1.5)),
        "plain_ms": timer(lambda: plain(*args, zeros, 0.0, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=c * k)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "floor_ms": floor_ms(torch, timer, floor, c, k),
    }


def outofcore_phase(torch, np, tapi, ops, ref, counters, device, timer, floor, graph, main_res,
                    main_peak, main_rss, tiny: bool, ident: str) -> tuple:
    """Phase 21: out-of-core graphs on the card. ``main_peak`` is phase 2's
    (peak device memory, memory allocated before the run), ``main_rss`` the
    process's peak RSS after phase 2. Returns the kernel rows of the two rows
    entries and the launches of their main paths (the mapped full-size
    ``fennel``, the mapped ``cuttana-parallel``)."""
    import tempfile

    from repro_torch.graph.external import ExternalCSRGraph, convert_csr, convert_edge_list
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.stream import ShardedStream, stream_order

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ooc") as td:
        # ------------------------------------------------- (a) rmat40000
        n = 40_000
        small = rmat_graph(n, avg_degree=12, seed=0)
        edges_path = str(Path(td) / "edges.npy")
        np.save(edges_path, small.edges_array())
        bin_path = str(Path(td) / "rmat40000.bin")
        t0 = time.perf_counter()
        stats = convert_edge_list(edges_path, bin_path, num_vertices=n)
        convert_s = time.perf_counter() - t0
        check(stats["file_bytes"] == OUTOFCORE_FILE_BYTES == Path(bin_path).stat().st_size,
              f"rmat40000: converted file has {stats['file_bytes']} bytes, "
              f"expected {OUTOFCORE_FILE_BYTES}")
        log(json.dumps({"phase": 21, "graph": "rmat40000 avg_degree 12", "convert_seconds":
                        convert_s, **{k_: stats[k_] for k_ in (
                            "file_bytes", "raw_bytes", "compression_ratio", "num_edges")}}))
        mapped = ExternalCSRGraph(bin_path)
        for algo in ("fennel", "cuttana", "cuttana-parallel"):
            params = {"num_shards": NUM_SHARDS} if algo == "cuttana-parallel" else None
            spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random",
                                      seed=0, params=params)
            variants = [("resident", small, spec), ("mapped", mapped, spec)]
            if params:
                variants.append(("mapped-sync", mapped,
                                 spec.replace(params={**params, "prefetch": "off"})))
            results = {}
            for backing, g, vspec in variants:
                reset_counts(*counters)
                res = tapi.partition(g, vspec, device=device)
                sync(torch, device)
                counts = (ops.launches, ops.sharded_launches, ops.rows_launches,
                          ops.sharded_rows_launches)
                calls = res.telemetry.get("kernel_calls", 0) if device.type == "cuda" else 0
                gather_i = 1 if params else 0
                want = [0, 0, 0, 0]
                want[gather_i + (2 if backing != "resident" else 0)] = calls
                check(list(counts) == want,
                      f"rmat40000 {algo} {backing}: launches {counts}, expected {want}")
                if backing == "mapped" and params:
                    launches["sharded_rows"] = counts[3]
                results[backing] = res
                q = res.quality()
                check(q["edge_cut"] == OUTOFCORE_EDGE_CUT[algo],
                      f"rmat40000 {algo} {backing}: edge_cut {q['edge_cut']} != "
                      f"{OUTOFCORE_EDGE_CUT[algo]}")
                check(np.array_equal(res.assignment, results["resident"].assignment),
                      f"rmat40000 {algo}: {backing} and resident assignments differ")
                tel = res.telemetry
                log(json.dumps({
                    "phase": 21, "graph": "rmat40000", "algo": algo, "backing": backing,
                    "prefetch": vspec.params.prefetch, "edge_cut": q["edge_cut"],
                    "timings": res.timings, "kernel_calls": tel.get("kernel_calls"),
                    "launches": dict(zip(("gather", "sharded", "rows", "sharded_rows"), counts)),
                    **{key: tel.get(key) for key in (
                        "peak_graph_bytes", "mapped_graph_bytes", "compressed_graph_bytes",
                        "decode_wall_s", "prefetch_hit_rate", "prefetch_wait_s")},
                }))
        del mapped, results, small

        # ------------------------------------------------- (b) full size
        if tiny:
            graph = rmat_graph(1 << 12, avg_degree=16, seed=0)
            main_res = tapi.partition(graph, main_spec(tapi), device=device)
            main_rss = None  # the rehearsal's process peak is not phase 2's
        scale = int(np.log2(graph.num_vertices))
        full_path = str(Path(td) / f"rmat{scale}.bin")
        t0 = time.perf_counter()
        convert_csr(graph, full_path)
        write_s = time.perf_counter() - t0
        graph_device_bytes = graph.indptr.nbytes + graph.indices.nbytes
        out = str(Path(td) / "assignment.npy")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--mapped-child", full_path,
             "--child-out", out] + (["--tiny"] if tiny else []),
            capture_output=True, text=True, timeout=900,
        )
        child_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"mapped child failed:\n{proc.stdout}\n{proc.stderr}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        got = np.load(out)
        chunks = -(-graph.num_vertices // CHUNK)
        expect_rows = chunks if device.type == "cuda" else 0
        check(np.array_equal(got, main_res.assignment),
              f"rmat 2^{scale}: mapped and resident fennel assignments differ")
        check(child["kernel_calls"] == chunks,
              f"mapped fennel: kernel_calls {child['kernel_calls']} != {chunks} chunks")
        check(child["launches"] == {"rows": expect_rows, "sharded_rows": 0, "gather": 0,
                                    "sharded": 0},
              f"mapped fennel: launches {child['launches']}, expected {expect_rows} rows launches")
        check(child["quality"] == main_res.quality(),
              f"rmat 2^{scale}: mapped quality scan differs from phase 2's")
        launches["rows"] = child["launches"]["rows"]
        saved = None
        main_peak, main_base = main_peak  # phase 2's peak and what it started from
        if device.type == "cuda":
            saved = main_peak - child["max_memory_allocated"]
            check(saved >= graph_device_bytes,
                  f"mapped peak device memory {child['max_memory_allocated']} is not below the "
                  f"resident {main_peak} by the graph's {graph_device_bytes} bytes")
        log(json.dumps({
            "phase": 21, "graph": f"rmat 2^{scale} avg_degree 16", "file_bytes":
            Path(full_path).stat().st_size, "write_seconds": write_s, "child_seconds": child_s,
            "resident_max_memory_allocated": main_peak,
            "resident_allocated_before": main_base, "graph_device_bytes": graph_device_bytes,
            "device_bytes_saved": saved, "resident_peak_rss_bytes": main_rss,
            "resident_stream_seconds": main_res.timings["stream_seconds"],
            "mapped": child, "device": ident,
        }))

        # --------------------------------------- (c) rows entries' shapes
        full = ExternalCSRGraph(full_path)
        ids = stream_order(full, "random", 0)
        rng = np.random.default_rng(21)
        s4 = ShardedStream.from_ids(ids, NUM_SHARDS)
        shapes = [
            rows_row(torch, np, ops, ref, device, timer, floor, rng, "mapped_chunk512_k8",
                     full, [ids[:CHUNK]], 8),
            rows_row(torch, np, ops, ref, device, timer, floor, rng,
                     f"mapped_superstep_s{NUM_SHARDS}x{CHUNK}_k8", full,
                     [sh[:CHUNK] for sh in s4.shards], 8),
        ]
        for row in shapes:
            log(json.dumps({"phase": 21, **row}))
        del full
    log(f"phase 21: {time.perf_counter() - t_phase:.3f} s")
    return shapes, launches


def serving_spec(tapi, algo: str):
    """``benchmarks/serving.py``'s ``_spec`` at k=8, seed 0."""
    if algo in ("random", "hdrf"):
        return tapi.PartitionSpec(algo=algo, k=8, seed=0)
    return tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0)


def sim_report(rep) -> dict:
    """A serving report without its wall-clock fields."""
    d = rep.to_dict()
    for key in ("wall_s", "qps_wall"):
        d.pop(key)
    d["latency_ms"] = {"sim": d["latency_ms"]["sim"]}
    return d


def same_answers(np, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(va, b[qid]) if isinstance(va, np.ndarray) else va == b[qid]
        for qid, va in a.items())


def serving_phase(torch, np, tapi, ops, ref, counters, device, timer, floor, graph, main_res,
                  tiny: bool, ident: str) -> tuple:
    """Phase 22: the graph-DB study and partition-aware serving, fed by
    partitions made on the card. (a) ``benchmarks/serving.py``'s recipe with
    the port against the committed ``serving/rmat8000/*`` rows; (b) phase 2's
    2^22 ``fennel`` partition served at replication budget 0.05, at auto and
    at one worker, against each other and the ``QueryEngine``, and the DB
    study on it; (c) the CLI on the card in child processes. Returns the
    kernel row ``serving_rmat8000_chunk512_k8`` and the gather launches of
    (a)'s partitions by algorithm."""
    import tempfile

    from repro_torch.db import QueryEngine
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.metrics import quality_report
    from repro_torch.graph.stream import stream_order
    from repro_torch.serve.graph import QueryMix, build_workload, run_load

    t_phase = time.perf_counter()
    # ------------------------------------------------ (a) serving/rmat8000
    small = rmat_graph(8000, avg_degree=12, seed=0)
    workload = build_workload(small, 2000, QueryMix(), seed=1)
    launches, reports, quality = {}, {}, {}
    for algo in SERVING_ALGOS:
        reset_counts(*counters)
        res = tapi.partition(small, serving_spec(tapi, algo), device=device)
        sync(torch, device)
        calls = res.telemetry.get("kernel_calls", 0)
        counts = (ops.launches, ops.sharded_launches, ops.rows_launches,
                  ops.sharded_rows_launches)
        want = (calls if device.type == "cuda" else 0, 0, 0, 0)
        check(counts == want, f"rmat8000 {algo}: launches {counts}, expected {want}")
        launches[algo] = counts[0]
        part = res.vertex_assignment()
        t0 = time.perf_counter()
        rep = run_load(res.serve(store_results=False), workload=workload, concurrency=1000)
        load_s = time.perf_counter() - t0
        reports[algo] = rep
        q = quality_report(small, part, 8, device)
        quality[algo] = (q, calls)
        row = {
            "bench": f"serving/rmat8000/{algo}", "algo": algo, "num_queries": rep.num_queries,
            "concurrency": rep.concurrency, "qps_sim": rep.qps_sim,
            "p99_sim_ms": rep.latency_ms["sim"]["p99"], "p50_sim_ms": rep.latency_ms["sim"]["p50"],
            "rpcs": rep.rpcs, "messages": rep.messages, "wire_bytes": rep.wire_bytes,
            "local_queries": rep.local_queries, "edge_cut": q["edge_cut"],
            "communication_volume": q["comm_volume"],
        }
        check(row == SERVING_ROWS[row["bench"]],
              f"{row['bench']}: {row} != the committed {SERVING_ROWS[row['bench']]}")
        log(json.dumps({"phase": 22, **row, "kernel_calls": calls, "launches": counts[0],
                        "qps_wall": rep.qps_wall, "wall_s": rep.wall_s, "load_seconds": load_s,
                        "partition_seconds": res.timings["total_s"], "device": ident}))
    res = tapi.partition(small, serving_spec(tapi, "cuttana"), device=device)
    base = run_load(res.serve(replication_budget=0.0), workload=workload[:500],
                    concurrency=1000)
    repl = run_load(res.serve(replication_budget=0.05), workload=workload[:500],
                    concurrency=1000)
    row = {
        "bench": "serving/rmat8000/cuttana/replication", "algo": "cuttana",
        "replication_budget": 0.05, "rpcs_base": base.rpcs, "rpcs_replicated": repl.rpcs,
        "rpc_reduction": 1.0 - repl.rpcs / max(base.rpcs, 1),
        "answers_identical": same_answers(np, base.answers(), repl.answers()),
        **{f"replication_{key}": val for key, val in repl.replication.items()},
    }
    check(row == SERVING_ROWS[row["bench"]], f"{row['bench']}: {row}")
    qps = {a: reports[a].qps_sim for a in SERVING_ALGOS}
    p99 = {a: reports[a].latency_ms["sim"]["p99"] for a in SERVING_ALGOS}
    order_row = {
        "bench": "serving/rmat8000/ordering",
        "qps_cuttana_over_random": qps["cuttana"] / qps["random"],
        "p99_cuttana_over_fennel": p99["cuttana"] / p99["fennel"],
        "p99_cuttana_over_hdrf": p99["cuttana"] / p99["hdrf"],
        "throughput_ordering_ok": bool(qps["cuttana"] > qps["random"]),
        "tail_ordering_ok": bool(p99["cuttana"] <= 1.05 * min(p99["fennel"], p99["hdrf"])),
    }
    check(order_row == SERVING_ROWS[order_row["bench"]], f"{order_row['bench']}: {order_row}")
    log(json.dumps({"phase": 22, **row}))
    log(json.dumps({"phase": 22, **order_row}))
    # the gather entry on the first chunk of that cuttana stream (random
    # order, seed 0), against its plain version
    kernel_row = gather_row(torch, np, ops, ref, small.to(device), small, device, timer, floor,
                            np.random.default_rng(22), "serving_rmat8000_chunk512_k8",
                            stream_order(small, "random", 0)[:CHUNK], 8)
    log(json.dumps({"phase": 22, **kernel_row}))

    # ---------------------------------------- (b) phase 2's 2^22 partition
    scale = int(np.log2(graph.num_vertices))
    big_workload = build_workload(graph, SERVING_QUERIES, QueryMix(), seed=1)
    runs = []
    for workers in (0, 1):
        t0 = time.perf_counter()
        svc = main_res.serve(replication_budget=0.05, max_workers=workers, store_results=True)
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep = run_load(svc, workload=big_workload, concurrency=1000)
        runs.append((rep, plan_s, time.perf_counter() - t0, svc.workers))
        del svc
    (rep, _, _, _), (one, _, _, _) = runs
    check(same_answers(np, rep.answers(), one.answers()),
          f"rmat 2^{scale} serving: auto and one-worker answers differ")
    check(sim_report(rep) == sim_report(one),
          f"rmat 2^{scale} serving: auto and one-worker sim metrics or counters differ")
    answers = rep.answers()
    engine = QueryEngine(graph, main_res.vertex_assignment(), 8)
    t0 = time.perf_counter()
    for kind, run in (("one_hop", engine.one_hop), ("two_hop", engine.two_hop)):
        qids = [i for i, (kd, _) in enumerate(big_workload) if kd == kind]
        seeds = np.array([big_workload[i][1] for i in qids], dtype=np.int64)
        # queries are independent: the engine answers slices of them on 8
        # threads (numpy's unique and concatenate release the lock)
        with ThreadPoolExecutor(8) as pool:
            got = [a for part in pool.map(lambda idx: run(seeds[idx])[0],
                                          np.array_split(np.arange(seeds.size), 8))
                   for a in part]
        check(all(np.array_equal(answers[i], g.astype(np.int64)) for i, g in zip(qids, got)),
              f"rmat 2^{scale} serving: {kind} answers differ from the QueryEngine's")
    engine_s = time.perf_counter() - t0
    check(all(answers[i] == graph.degree(s) for i, (kd, s) in enumerate(big_workload)
              if kd == "point"), f"rmat 2^{scale} serving: point answers are not degrees")
    dbs = {}
    for hops in (1, 2):
        t0 = time.perf_counter()
        dbs[hops] = {**main_res.db(hops=hops, num_queries=256),
                     "seconds": time.perf_counter() - t0}
        d = dbs[hops]
        check(d["total_rpcs"] > 0 and all(np.isfinite(d[key]) for key in (
            "qps", "p99_latency_ms", "mean_latency_ms")),
              f"rmat 2^{scale} db hops={hops}: {d}")
    log(json.dumps({
        "phase": 22, "graph": f"rmat 2^{scale} avg_degree 16", "algo": "fennel", "k": 8,
        "replication_budget": 0.05, "queries": len(big_workload), "concurrency": 1000,
        "replication": rep.replication, "qps_sim": rep.qps_sim,
        "latency_sim_ms": rep.latency_ms["sim"], "rpcs": rep.rpcs, "messages": rep.messages,
        "wire_bytes": rep.wire_bytes, "scanned_edges": rep.scanned_edges,
        "local_queries": rep.local_queries, "kind_counts": rep.kind_counts,
        "runs": [{"workers": w, "plan_seconds": p, "run_seconds": r, "wall_s": x.wall_s,
                  "qps_wall": x.qps_wall, "latency_wall_ms": x.latency_ms["wall"]}
                 for x, p, r, w in runs],
        "identical_across_workers": True, "equal_to_query_engine": True,
        "query_engine_seconds": engine_s, "db": dbs,
        "device": ident,
    }))
    del runs, rep, one, answers, engine

    # ------------------------------------------------ (c) the CLI on the card
    from repro_torch.api.cli import main as cli_main

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    dev = ["--device", device.type]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli") as td:
        specs = {}
        for algo in ("cuttana", "fennel"):
            specs[algo] = Path(td) / f"{algo}.json"
            specs[algo].write_text(serving_spec(tapi, algo).to_json())
        out = {}
        commands = {
            "partition": ["partition", "--rmat", "8000", "--avg-degree", "12", "--with-db"],
            "serve-bench": ["serve-bench", "--rmat", "8000", "--avg-degree", "12",
                            "--queries", "2000", "--concurrency", "1000", "--load-seed", "1"],
        }

        def run_cli(name):  # the two children run side by side
            path = Path(td) / f"{name}.json"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.api.cli", *commands[name], "--spec",
                 str(specs["cuttana"]), "--out", str(path), *dev],
                env=env, capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"cli {name} failed:\n{proc.stdout}\n{proc.stderr}")
            return name, (json.loads(path.read_text()), time.perf_counter() - t0)

        with ThreadPoolExecutor(len(commands)) as pool:
            out.update(pool.map(run_cli, commands))
        # the engine-backed spec through the CLI in this process, its launches
        # counted: cuttana places every vertex on the host, fennel scores a
        # chunk a launch
        path = Path(td) / "partition_fennel.json"
        reset_counts(*counters)
        t0 = time.perf_counter()
        check(cli_main(["partition", "--rmat", "8000", "--avg-degree", "12", "--spec",
                        str(specs["fennel"]), "--out", str(path), *dev]) == 0,
              "cli partition fennel failed")
        sync(torch, device)
        out["partition fennel"] = (json.loads(path.read_text()), time.perf_counter() - t0)
        cli_launches = ops.launches
        for name, algo in (("partition", "cuttana"), ("partition fennel", "fennel")):
            report, _ = out[name]
            q, calls = quality[algo]
            check(report["quality"]["edge_cut"] == q["edge_cut"]
                  and report["quality"]["comm_volume"] == q["comm_volume"],
                  f"cli {name}: quality {report['quality']} != phase 22(a)'s {algo}")
            check(report["telemetry"]["kernel_calls"] == calls,
                  f"cli {name}: kernel_calls {report['telemetry']['kernel_calls']} != "
                  f"phase 22(a)'s {calls}")
            check(report["device"].startswith(device.type), f"cli {name}: {report['device']}")
        calls = out["partition fennel"][0]["telemetry"]["kernel_calls"]
        check(calls > 0 and cli_launches == (calls if device.type == "cuda" else 0),
              f"cli partition fennel: {cli_launches} launches, kernel_calls {calls}")
        db = out["partition"][0]["db"]
        check(db["one_hop"]["total_rpcs"] > 0 and db["two_hop"]["total_rpcs"] > 0,
              f"cli partition cuttana: db {db}")
        serving = out["serve-bench"][0]["serving"]
        want = SERVING_ROWS["serving/rmat8000/cuttana"]
        check(serving["qps_sim"] == want["qps_sim"] and serving["rpcs"] == want["rpcs"],
              f"cli serve-bench: qps_sim {serving['qps_sim']} rpcs {serving['rpcs']} != the "
              f"committed {want['qps_sim']} / {want['rpcs']}")
        log(json.dumps({
            "phase": 22, "cli": {name: {"seconds": sec, "device": r.get("device"),
                                        "kernel_calls": r.get("telemetry", {}).get("kernel_calls")}
                                 for name, (r, sec) in out.items()},
            "cli_fennel_launches": cli_launches, "db_cuttana": db,
            "serve_bench": {key: serving[key] for key in (
                "qps_sim", "rpcs", "wire_bytes", "qps_wall", "wall_s")},
        }))
    log(f"phase 22: {time.perf_counter() - t_phase:.3f} s")
    return kernel_row, launches


def check_quality(np, graph, part, q, k: int, what: str) -> None:
    """The device quality scan against a host recomputation."""
    check(part.shape == (graph.num_vertices,) and part.min() >= 0 and part.max() < k,
          f"{what}: assignment has the wrong shape or ids")
    src = np.repeat(np.arange(graph.num_vertices, dtype=np.int64), graph.degrees)
    host_cut = int((part[src] != part[graph.indices]).sum()) // 2 / graph.num_edges
    del src
    check(q["edge_cut"] == host_cut, f"{what}: device edge_cut {q['edge_cut']} != host {host_cut}")
    e_mass = np.bincount(part, weights=graph.degrees.astype(np.float64), minlength=k)
    check(q["edge_imbalance"] == float(e_mass.max() / e_mass.mean()),
          f"{what}: edge imbalance differs from host")


def reset_counts(*modules) -> None:
    """Zero the launch counts of every kernel wrapper module."""
    for mod in modules:
        mod.reset()


def profile_totals(profile: dict) -> dict:
    """The parallel engine's profile without its per-superstep rows."""
    return {k: v for k, v in profile.items() if k != "per_superstep"}


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def attention_pairs(np, tq: int, tk: int, causal: bool, window, q_offset: int) -> int:
    """The (query, key) pairs the masks keep: the work the data needs."""
    qpos = np.arange(tq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, tk - 1) if causal else np.full(tq, tk - 1, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(tq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def within(got, want, tol: float) -> tuple[bool, float]:
    """``assert_allclose(rtol=tol, atol=tol)``'s rule, and the max abs error."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def worst_row_rel_l2(got, want) -> float:
    """The largest ``|got - want| / |want|`` (L2 over the last axis) of any row."""
    want = want.float()
    diff = (got.float() - want).norm(dim=-1)
    return float((diff / want.norm(dim=-1).clamp_min(1e-30)).max())


def flash_row(torch, np, F, fa, fa_ref, timer, name, b, hq, hkv, tq, tk, dh, dtype,
              causal=True, window=None, q_offset=0, library_causal=None, reps=(100, 5)):
    """Phase 12: one shape of the attention kernel against its plain version
    (``tests/test_kernels.py``'s tolerances), its device time and its bound;
    with ``library_causal`` set (the main shapes) also the per-call, plain
    and ``scaled_dot_product_attention`` times."""
    device = timer.device
    gen = torch.Generator(device=device).manual_seed(tq * 7 + tk + dh)
    q, k, v = (torch.randn(s, generator=gen, device=device, dtype=torch.float32).to(dtype)
               for s in ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    variant = fa.kernel_variant(dtype, tq, hq // hkv, dh, fa.is_aligned(q, k, v))
    before, splits_before = dict(fa.variant_launches), dict(fa.split_launches)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    sync(torch, device)
    ran = {n: fa.variant_launches[n] - before[n] for n in fa.VARIANTS}
    check(ran == {n: int(n == variant and device.type == "cuda") for n in fa.VARIANTS},
          f"flash {name}: expected one launch of {variant}, the variants ran {ran}")
    # the decode variant's shares of the cache, as the launch recorded them
    n_split = next((n for n, c in fa.split_launches.items() if c != splits_before.get(n, 0)),
                   None)
    tname = str(dtype).split(".")[1]
    ok, err = within(got, want, FLASH_TOL[tname])
    check(ok, f"flash {name}: kernel differs from plain version beyond {FLASH_TOL[tname]} ({err})")
    row_err = worst_row_rel_l2(got, want)
    check(row_err <= FLASH_ROW_RTOL,
          f"flash {name}: a row differs from the plain version by {row_err} relative L2 "
          f"(> {FLASH_ROW_RTOL})")
    del want
    call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    pairs = attention_pairs(np, tq, tk, causal, window, q_offset) * b * hq
    flops = 4 * pairs * dh
    nbytes = (2 * b * hq * tq * dh + 2 * b * hkv * tk * dh) * q.element_size()
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(flops / rate, pairs / EXP_PER_S) * 1e3  # the products, or one exp a pair
    ms = timer.device_ms(call, reps=reps[0], replays=reps[1])
    row = {
        "shape": name, "variant": variant, "n_split": n_split, "b": b, "hq": hq, "hkv": hkv,
        "tq": tq, "tk": tk, "dh": dh, "dtype": tname, "causal": causal, "window": window,
        "q_offset": q_offset,
        "max_abs_err": err, "max_row_rel_l2": row_err, "ms": ms,
        "tflops": flops / ms / 1e9, "flops": flops, "exps": pairs, "bytes": nbytes,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    if library_causal is not None:
        n = max(2, reps[0] // 2)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=library_causal, enable_gqa=True)
        _, lib_err = within(lib(), got, FLASH_TOL[tname])
        row.update({
            "call_ms": timer(call, reps=n, warmup=1),
            "plain_ms": timer(lambda: fa_ref.flash_attention_ref(q, k, v, **kw), reps=2, warmup=1),
            "library_ms": timer(lib, reps=n, warmup=1), "library_max_abs_diff": lib_err,
        })
    return row


def flash_kernel_checks(torch, np, F, fa, fa_ref, timer, tiny: bool):
    """Phase 12: the attention kernel at the test shapes, the decode-offset
    sweep, and one qwen3-8b layer at prefill and at a 32k decode step (B=8,
    phase 17's batch, then B=32)."""
    rows = []
    if tiny:  # the reduced qwen3 layer (Hq=4, Hkv=2, Dh=32)
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "prefill_reduced", 1, 4, 2,
                              256, 256, 32, torch.bfloat16, library_causal=True, reps=(3, 1)))
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "decode_reduced", 2, 4, 2, 1,
                              512, 32, torch.bfloat16, q_offset=511, library_causal=False,
                              reps=(3, 1)))
    else:
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "qwen3_prefill_t8192", 1, 32, 8,
                              8192, 8192, 128, torch.bfloat16, library_causal=True, reps=(3, 2)))
        for b in (8, 32):
            rows.append(flash_row(torch, np, F, fa, fa_ref, timer, f"qwen3_decode_tk32768_b{b}",
                                  b, 32, 8, 1, 32768, 128, torch.bfloat16, q_offset=32767,
                                  library_causal=False, reps=(5, 2)))
    if timer.device.type == "cuda":
        torch.cuda.empty_cache()  # the plain version's scores at the prefill shape
    for dtype in (torch.float32, torch.bfloat16):
        for b, hq, hkv, tq, tk, dh, causal, window in (
            (1, 2, 2, 128, 128, 64, True, None), (2, 4, 2, 128, 128, 64, True, None),
            (1, 2, 1, 256, 256, 32, False, None), (1, 2, 2, 128, 128, 64, True, 32),
            (2, 2, 2, 64, 64, 128, True, None),
        ):
            rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "test_kernels", b, hq, hkv,
                                  tq, tk, dh, dtype, causal, window, reps=(20, 2)))
    for q_offset in (0, 1, 127, 128, 200):
        for tq in (1, 4):
            rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "decode_offset_sweep", 2, 4,
                                  4, tq, 256, 64, torch.float32, q_offset=q_offset, reps=(20, 2)))
    # 65,536 batches: one more than grid y holds, on every variant
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "grid_cap_b65536_decode", 65536,
                              1, 1, 1, 1, 32, dtype, reps=(5, 1)))
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "grid_cap_b65536_tq17", 65536,
                              1, 1, 17, 17, 32, dtype, reps=(5, 1)))  # fma, wgmma_bf16
        rows.append(flash_row(torch, np, F, fa, fa_ref, timer, "grid_cap_b65536_hq2_tq16",
                              65536, 2, 1, 16, 16, 32, dtype, reps=(5, 1)))  # fma_short
    for row in rows:
        log(json.dumps({"phase": 12, **row}))
    return rows


def scan_row(torch, scan, scan_ref, timer, name, bsz, t, d, n, dtype, tol, model_a=False,
             main=False):
    """Phase 13: one shape of the selective-scan kernel against its plain
    version (y and h_T), its device time and its bound."""
    device = timer.device
    gen = torch.Generator(device=device).manual_seed(d + t)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    x = rnd(bsz, t, d).to(dtype)
    dt = (rnd(bsz, t, d).abs() * 0.1 + 0.01).to(dtype)
    if model_a:  # the model's A = -exp(a_log) = -(1..N) on every channel
        a = -torch.arange(1, n + 1, dtype=torch.float32, device=device).expand(d, n).contiguous()
    else:
        a = -(rnd(d, n).abs() + 0.1)
    b, c = rnd(bsz, t, n).to(dtype), rnd(bsz, t, n).to(dtype)
    d_skip = rnd(d)
    args = (x, dt, a, b, c, d_skip)
    y, h = scan.selective_scan(*args)
    y_want, h_want = scan_ref.selective_scan_ref(*args)
    sync(torch, device)
    ok_y, err_y = within(y, y_want, tol)
    ok_h, err_h = within(h, h_want, tol)
    check(ok_y and ok_h, f"scan {name}: kernel differs from plain version beyond {tol} "
                         f"(y {err_y}, h_T {err_h})")
    call = lambda: scan.selective_scan(*args)  # noqa: E731
    item = x.element_size()
    nbytes = 3 * bsz * t * d * item + 2 * bsz * t * n * item + d * n * 4 + d * 4 + bsz * d * n * 4
    ops = 7 * bsz * t * d * n  # per (t, d, n): dt*A, exp, *h, *B, +, *C, the sum over N
    exps = bsz * t * d * n  # the exp of each (t, d, n) on the special-function units
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(ops / FP32_OPS_PER_S, exps / EXP_PER_S) * 1e3
    ms = timer.device_ms(call, reps=10 if main else 20, replays=2)
    row = {
        "shape": name, "b": bsz, "t": t, "d": d, "n": n, "dtype": str(dtype).split(".")[1],
        "variant": f"states{min(scan.STATES_PER_THREAD, n)}", "tol": tol,
        "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y, "max_abs_err_h": err_h,
        "ms": ms, "exp_bound_share": exps / EXP_PER_S * 1e3 / ms,
        "bytes": nbytes, "ops": ops, "exps": exps,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    if main:
        row.update({
            "call_ms": timer(call, reps=10, warmup=1),
            "plain_ms": timer(lambda: scan_ref.selective_scan_ref(*args), reps=1, warmup=1),
            "library_ms": None,  # no single PyTorch call computes the scan
        })
    return row


def scan_kernel_checks(torch, scan, scan_ref, timer, tiny: bool):
    """Phase 13: the scan kernel at one falcon-mamba-7b layer and at the
    test shapes."""
    t, d = (256, 256) if tiny else (8192, 8192)
    rows = [scan_row(torch, scan, scan_ref, timer, f"falcon_layer_t{t}_d{d}", 1, t, d, 16,
                     torch.float32, SCAN_LAYER_TOL, model_a=True, main=True)]
    for dtype in (torch.float32, torch.bfloat16):
        for bsz, t, d, n in ((1, 16, 64, 8), (2, 32, 128, 16), (2, 8, 512, 16)):
            rows.append(scan_row(torch, scan, scan_ref, timer, "test_kernels", bsz, t, d, n,
                                 dtype, SCAN_TOL[str(dtype).split(".")[1]]))
    # batch 65,536, one more row than grid y holds, at the smallest width
    rows.append(scan_row(torch, scan, scan_ref, timer, "grid_cap_b65536", 65536, 3, 1, 8,
                         torch.float32, SCAN_TOL["float32"]))
    for row in rows:
        log(json.dumps({"phase": 13, **row}))
    return rows


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_numel(v) for v in tree)
    return tree.numel()


def profile_lm(torch, fn, device, kernel_name: str) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after a profiled warm-up
    call (a short window loses its first device events otherwise)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            sync(torch, device)
            wall = time.perf_counter() - t0
            prof.step()
    return {"profiled_wall_s": wall, **device_time(prof, wall, on_card, kernel_name)}


def lm_phase(torch, np, counters, device, arch: str, tiny: bool, ident: str) -> tuple:
    """Phases 14-15: ``arch`` at full width and depth (reduced with
    ``--tiny``): prefill through ``make_prefill_step``, then the serve loop,
    with the launches of both kernels checked on each path. Returns the
    record, the model and its weights (phase 17 decodes with qwen3's)."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.launch.serve import prefill_into_cache, serve
    from repro_torch.models import Model
    from repro_torch.serve.lm import make_prefill_step

    cfg = get_model_config(("reduced:" if tiny else "") + arch)
    model = Model(cfg, device)
    on_card = device.type == "cuda"
    n_attn = sum(s.mixer == "attn" for s in cfg.layers())
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layers())
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    sync(torch, device)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    seq = 64 if tiny else 8192
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, (1, seq)), device=model.device)
    prefill = make_prefill_step(model)
    reset_counts(*counters)
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    sync(torch, device)
    prefill_s = time.perf_counter() - t0
    prefill_launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    expect = {"flash_attention": n_attn, "selective_scan": n_mamba} if on_card else \
        {"flash_attention": 0, "selective_scan": 0}
    check(prefill_launches == expect,
          f"{arch} prefill launched {prefill_launches}, expected {expect}")
    # a bf16 prefill of T=8192 runs every attention layer on the tensor cores
    prefill_variants = dict(fa.variant_launches)
    expect = {n: n_attn * (n == "wgmma_bf16") * on_card for n in fa.VARIANTS}
    check(prefill_variants == expect,
          f"{arch} prefill ran the attention variants {prefill_variants}, expected {expect}")
    check(all(m.launches == 0 for m in counters if m not in (fa, scan)),
          f"{arch} prefill launched a partitioning or analytics kernel")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"{arch} prefill logits have the wrong shape or non-finite entries")
    prefill_peak = torch.cuda.max_memory_allocated() if on_card else None
    del logits
    # the full-sequence path (prefill kernel mode) against the decode path
    # (one token a step) on a short prompt at full width
    short = tokens[:, :16]
    lp = prefill(params, {"tokens": short}).float()
    ld, _ = prefill_into_cache(model, params, model.init_cache(1, 16), short)
    rel = float((lp - ld.float()).norm() / lp.norm())
    check(rel < 0.1, f"{arch}: prefill and decode-path logits differ by {rel} (relative L2)")
    # the serve loop
    b, plen, gen = (2, 8, 4) if tiny else (8, 128, 32)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, plen)), device=model.device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    out, timings = serve(model, params, prompts, gen)
    serve_launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    expect = {"flash_attention": n_attn * (plen + gen - 1), "selective_scan": 0} if on_card \
        else {"flash_attention": 0, "selective_scan": 0}
    check(serve_launches == expect, f"{arch} serve launched {serve_launches}, expected {expect}")
    serve_variants = dict(fa.variant_launches)  # a decode step: g * Tq = 4 <= 16
    expect = {n: serve_launches["flash_attention"] * (n == "decode_split") for n in fa.VARIANTS}
    check(serve_variants == expect,
          f"{arch} serve ran the attention variants {serve_variants}, expected {expect}")
    # the serve loop's short cache is one share: one kernel a call, no merge
    serve_splits = dict(fa.split_launches)
    expect = {1: serve_launches["flash_attention"]} if on_card and n_attn else {}
    check(serve_splits == expect, f"{arch} serve split its cache as {serve_splits} "
                                  f"(n_split: launches), expected {expect}")
    check(tuple(out.shape) == (b, gen) and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"{arch} serve produced ids of the wrong shape or range")
    serve_peak = torch.cuda.max_memory_allocated() if on_card else None
    # profiled: one qwen3 decode step, one falcon prefill
    if n_attn:
        cache = model.init_cache(b, plen + gen)
        tok = prompts[:, :1]
        prof = profile_lm(torch, lambda: model.decode_step(params, cache, tok, plen), device,
                          "attn_")
        profiled = f"decode_step b={b} pos={plen}"
    else:
        prof = profile_lm(torch, lambda: prefill(params, {"tokens": tokens}), device,
                          "scan_kernel")
        profiled = f"prefill b=1 t={seq}"
    record = {
        "arch": cfg.name, "params": tree_numel(params), "param_count": cfg.param_count(),
        "layers": cfg.num_layers, "dtype": cfg.dtype, "init_s": init_s,
        "prefill": {"batch": 1, "seq": seq, "seconds": prefill_s, "launches": prefill_launches,
                    "flash_variants": prefill_variants, "tokens_per_s": seq / prefill_s,
                    "max_memory_allocated": prefill_peak},
        "prefill_vs_decode_path_rel_l2": rel,
        "serve": {"batch": b, "prompt_len": plen, "gen": gen, **timings,
                  "launches": serve_launches, "flash_variants": serve_variants,
                  "split_launches": serve_splits, "max_memory_allocated": serve_peak,
                  "first_ids": out[0, :8].tolist()},
        "profile": {"what": profiled, **prof}, "device": ident,
    }
    return record, model, params


def fill_cache(torch, cache: list, generator) -> None:
    """Every tensor of a decode cache drawn from ``generator`` (N(0, 1)), in
    place: keys and values of the magnitude qk-norm and RoPE give."""
    for layer in cache:
        for t in layer.values():
            t.normal_(generator=generator)


def long_decode_phase(torch, np, counters, device, model, params, tiny: bool, ident: str) -> dict:
    """Phase 17: qwen3-8b decoding over a long cache at full width and depth
    (the reduced config and a 2,048 cache with ``--tiny``), with phase 14's
    weights: one layer's attention over the cache against the plain version,
    then ``decode_step``s from near the cache's end with their launches
    counted, then one step under ``torch.profiler``."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.models.attention import gqa_flash_decode

    cfg = model.cfg
    on_card = device.type == "cuda"
    n_attn = sum(s.mixer == "attn" for s in cfg.layers())
    b, seq, steps = (8, 2048, 4) if tiny else (8, 32768, 8)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # phase 14's activations and serve cache are gone
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = model.init_cache(b, seq)
    fill_cache(torch, cache, torch.Generator(device=model.device).manual_seed(17))
    sync(torch, device)
    fill_s = time.perf_counter() - t0
    # one layer's attention over the filled cache against the plain version
    gen = torch.Generator(device=model.device).manual_seed(18)
    q = torch.randn((b, cfg.n_heads, cfg.head_dim), generator=gen, device=model.device,
                    dtype=torch.float32).to(model.dtype)
    pos = seq - 1
    got = gqa_flash_decode(q, cache[0]["k"], cache[0]["v"], pos, None)
    want = fa_ref.flash_attention_ref(q[:, :, None], cache[0]["k"].transpose(1, 2),
                                      cache[0]["v"].transpose(1, 2), causal=True,
                                      q_offset=pos)[:, :, 0]
    tname = str(model.dtype).split(".")[1]
    ok, err = within(got, want, FLASH_TOL[tname])
    check(ok, f"long decode: layer attention differs from the plain version ({err})")
    row_err = worst_row_rel_l2(got, want)
    check(row_err <= FLASH_ROW_RTOL, f"long decode: a row differs by {row_err} relative L2")
    del q, got, want
    # the main path: decode steps from near the end of the cache
    rng = np.random.default_rng(17)
    tok = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, 1)), device=model.device)
    start = seq - steps
    sync(torch, device)
    reset_counts(*counters)
    step_s = []
    for i in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, tok, start + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        sync(torch, device)
        step_s.append(time.perf_counter() - t0)
    launches = {"flash_attention": fa.launches, "selective_scan": scan.launches}
    variants = dict(fa.variant_launches)
    splits = dict(fa.split_launches)
    expect = {"flash_attention": n_attn * steps * on_card, "selective_scan": 0}
    check(launches == expect, f"long decode launched {launches}, expected {expect}")
    # every launch split the long cache, all with one count
    n_split = next(iter(splits)) if len(splits) == 1 else None
    check(not on_card or (n_split is not None and n_split > 1),
          f"a {seq}-long cache at B={b} was not split into one count > 1: {splits}")
    expect = {n: n_attn * steps * on_card * (n == "decode_split") for n in fa.VARIANTS}
    check(variants == expect, f"long decode ran the attention variants {variants}, "
                              f"expected {expect}")
    check(all(m.launches == 0 for m in counters if m not in (fa, scan)),
          "long decode launched a partitioning or analytics kernel")
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          "long decode logits have the wrong shape or non-finite entries")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    per_step = sum(step_s[1:]) / (steps - 1)  # the first step warms the caches up
    prof = profile_lm(torch, lambda: model.decode_step(params, cache, tok, pos), device, "attn_")
    del cache, logits
    if on_card:
        torch.cuda.empty_cache()
    kv_bytes = 2 * n_attn * b * seq * cfg.n_kv_heads * cfg.head_dim * \
        torch.finfo(model.dtype).bits // 8
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": b,
        "cache_len": seq, "first_pos": start, "steps": steps, "n_split": n_split,
        "blocks_per_sm": fa.decode_blocks_per_sm(device, model.dtype, cfg.head_dim,
                                                 cfg.n_heads // cfg.n_kv_heads)
        if on_card else None,
        "cache_fill_s": fill_s, "kv_cache_bytes": kv_bytes,
        "attention_bound_ms_per_step": kv_bytes / HBM_BYTES_PER_S * 1e3,
        "layer_check": {"max_abs_err": err, "max_row_rel_l2": row_err},
        "step_seconds": step_s, "seconds_per_step": per_step, "tokens_per_s": b / per_step,
        "launches": launches, "flash_variants": variants, "max_memory_allocated": peak,
        "first_ids": tok[:, 0].tolist(),
        "profile": {"what": f"decode_step b={b} pos={pos}", **prof}, "device": ident,
    }


def long_cache_step(torch, cpu, params, card, dparams, toks) -> dict:
    """Phase 16: one decode step at the end of a seeded 8,192-long cache on
    the card and on the CPU; on the card the decode kernel splits it."""
    from repro_torch.kernels.flash_attention import ops as fa

    b, seq = toks.shape[0], 8192
    cache = cpu.init_cache(b, seq)
    fill_cache(torch, cache, torch.Generator().manual_seed(16))
    dcache = tree_to(cache, card.device)
    before = dict(fa.split_launches)
    got, _ = card.decode_step(dparams, dcache, toks[:, :1].to(card.device), seq - 1)
    sync(torch, card.device)
    ran = {n: c - before.get(n, 0) for n, c in fa.split_launches.items()
           if c != before.get(n, 0)}
    n_split = next(iter(ran)) if len(ran) == 1 else None
    check(card.device.type != "cuda" or (n_split is not None and n_split > 1),
          f"reduced decode at {seq}: the cache was not split into one count > 1 ({ran})")
    want, _ = cpu.decode_step(params, cache, toks[:, :1], seq - 1)
    ok, err = within(got.cpu(), want, 1e-4)
    check(ok, f"reduced decode at a {seq} cache: card and cpu logits differ beyond 1e-4 ({err})")
    check(torch.equal(got.argmax(-1).cpu(), want.argmax(-1)),
          f"reduced decode at a {seq} cache: greedy tokens differ")
    return {"cache_len": seq, "n_split": n_split, "max_abs_err": err, "greedy_tokens_equal": True}


def reduced_parity(torch, np, device) -> list:
    """Phase 16: each reduced config in float32 with the same weights on the
    card and on the CPU."""
    from repro_torch.configs import get_model_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model

    rows = []
    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_model_config(f"reduced:{arch}"), dtype="float32")
        cpu = Model(cfg, "cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        card = Model(cfg, device)
        dparams = tree_to(params, card.device)
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
        got, _ = card.forward(dparams, {"tokens": toks.to(card.device)})
        want, _ = cpu.forward(params, {"tokens": toks})
        ok, err = within(got.cpu(), want, 1e-4)
        check(ok, f"reduced {arch}: {device.type} and cpu logits differ beyond 1e-4 ({err})")
        g_card, _ = serve(card, dparams, toks[:, :8].to(card.device), 8)
        g_cpu, _ = serve(cpu, params, toks[:, :8], 8)
        check(torch.equal(g_card.cpu(), g_cpu), f"reduced {arch}: greedy tokens differ")
        row = {"arch": f"reduced:{arch}", "dtype": "float32", "max_abs_err": err,
               "greedy_tokens_equal": True}
        if any(s.mixer == "attn" for s in cfg.layers()):
            row["long_cache_decode"] = long_cache_step(torch, cpu, params, card, dparams, toks)
        rows.append(row)
    for row in rows:
        log(json.dumps({"phase": 16, **row}))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="rehearse every phase on the CPU at a tiny size (prints no result)")
    ap.add_argument("--mapped-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mapped_child:  # phase 21's child process
        return mapped_child(args.mapped_child, args.child_out, args.tiny)

    import numpy as np
    import torch

    if not args.tiny and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "(--tiny rehearses it on the CPU)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    import kernel_ablation_partition_score as score_ablation
    from outofcore_decode_study import PeakRss

    rss = PeakRss()  # phase 21 reports the process's peak RSS through phase 2
    import repro_torch.api as tapi
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.stream import ShardedStream
    from repro_torch.analytics import programs
    from repro_torch.kernels.ell_spmv import build as spmv_build
    from repro_torch.kernels.ell_spmv import ops as spmv
    from repro_torch.kernels.ell_spmv import ref as spmv_ref
    from repro_torch.kernels.partition_score import build, ops, ref
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import build as scan_build
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.mamba_scan import ref as scan_ref

    device = torch.device("cpu" if args.tiny else "cuda")
    timer = Timer(torch, device)
    counters = (ops, spmv, fa, scan)  # every kernel wrapper's launch count

    # ------------------------------------------------------------ phase 0
    ident = "cpu rehearsal" if args.tiny else gpu_identity()
    log(f"phase 0: {ident} | torch {torch.__version__} | cuda {torch.version.cuda}")
    floor = None  # the empty kernel of phases 1 and 5's launch floors
    scale = 14 if args.tiny else 22
    # one nvcc per kernel source, all started together; phase 1's graph is
    # generated on the host while they compile
    libraries = [] if args.tiny else [
        build.LIBRARY, spmv_build.LIBRARY, fa_build.LIBRARY, scan_build.LIBRARY]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries) + 1) as pool:
        floor_job = None if args.tiny else pool.submit(score_ablation.floor_library)
        build_jobs = [pool.submit(lib.load) for lib in libraries]
        t1 = time.perf_counter()
        graph = rmat_graph(1 << scale, avg_degree=16, seed=0)
        gen_s = time.perf_counter() - t1
        for job in build_jobs:
            job.result()
        if floor_job is not None:
            floor = floor_job.result()
    if not args.tiny:
        log(f"phase 0: kernels built (beside phase 1's graph) in "
            f"{time.perf_counter() - t0:.3f} s")
        for lib in libraries:
            log(f"phase 0: {lib.path.name}: nvcc {lib.build_seconds:.3f} s")
            for line in lib.build_log.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    log(f"phase 0: ptxas: {line.strip()}")

    # ------------------------------------------------------------ phase 1
    log(f"phase 1: rmat 2^{scale} generated in {gen_s:.3f} s (beside the builds): "
        f"{graph.num_vertices} vertices, {graph.num_edges} edges, "
        f"max degree {int(graph.degrees.max())}")
    dgraph = graph.to(device)
    shapes = kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor)

    # ------------------------------------------------------------ phase 2
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # allocated before the run: the graph's arrays (uploaded in phase 1) and
    # what phase 1's checks still hold
    main_base = torch.cuda.memory_allocated() if device.type == "cuda" else None
    reset_counts(*counters)
    res = tapi.partition(graph, main_spec(tapi), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    main_launches = ops.launches
    check(ops.sharded_launches == 0, "the sequential path launched the sharded kernel")
    q = res.quality()
    chunks = -(-graph.num_vertices // CHUNK)
    expect_launches = chunks if device.type == "cuda" else 0
    check(res.telemetry["kernel_calls"] == chunks,
          f"kernel_calls {res.telemetry['kernel_calls']} != {chunks} chunks")
    check(main_launches == expect_launches,
          f"kernel launched {main_launches} times on the main path, expected {expect_launches}")
    check_quality(np, graph, res.assignment, q, 8, "fennel")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    log(json.dumps({
        "phase": 2, "algo": "fennel", "graph": f"rmat 2^{scale} avg_degree 16",
        "num_vertices": graph.num_vertices, "num_edges": graph.num_edges,
        "edge_cut": q["edge_cut"], "comm_volume": q["comm_volume"],
        "vertex_imbalance": q["vertex_imbalance"], "edge_imbalance": q["edge_imbalance"],
        "stream_seconds": res.timings["stream_seconds"], "total_s": res.timings["total_s"],
        "kernel_calls": res.telemetry["kernel_calls"], "launches": main_launches,
        "variant": SCORE_VARIANT, "max_memory_allocated": peak,
        "memory_allocated_before": main_base, "device": ident,
    }))
    main_res = res  # phase 10 runs the analytics on this assignment
    # phase 21 holds the mapped run's peaks against these (the process's RSS
    # so far: phases 0-2, the graph generated and partitioned resident)
    main_peak, main_rss = (peak, main_base), rss.read()

    # ------------------------------------------------------------ phase 3
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    for algo in ("fennel", "cuttana"):
        spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0)
        reset_counts(*counters)
        on_dev = tapi.partition(web, spec, device=device)
        dev_launches = ops.launches
        on_cpu = tapi.partition(web, spec, device="cpu")
        check(np.array_equal(on_dev.assignment, on_cpu.assignment),
              f"web-s {algo}: {device.type} and cpu assignments differ")
        for r in (on_dev, on_cpu):
            check(r.quality()["edge_cut"] == WEB_S_EDGE_CUT[algo],
                  f"web-s {algo}: edge_cut {r.quality()['edge_cut']} != {WEB_S_EDGE_CUT[algo]}")
        log(json.dumps({
            "phase": 3, "dataset": "web-s", "algo": algo, "edge_cut": on_dev.quality()["edge_cut"],
            "identical_to_cpu": True, "kernel_calls": on_dev.telemetry["kernel_calls"],
            "launches": dev_launches, "timings_device": on_dev.timings,
            "timings_cpu": on_cpu.timings,
        }))
    dataset = "social-s" if args.tiny else "social-m"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res = tapi.partition(
        tapi.PartitionSpec(algo="cuttana", k=8, balance_mode="edge", order="random",
                           seed=0, source=f"dataset:{dataset}"),
        device=device,
    )
    q = res.quality()
    kp = res.telemetry["subpartitions"]
    if not args.tiny:
        check(q["edge_cut"] == SOCIAL_M_CUTTANA_EDGE_CUT,
              f"social-m cuttana: edge_cut {q['edge_cut']} != {SOCIAL_M_CUTTANA_EDGE_CUT}")
    log(json.dumps({
        "phase": 3, "dataset": dataset, "algo": "cuttana", "subpartitions": kp,
        "w_bytes": kp * kp * 8, "phase1_seconds": res.timings["phase1_seconds"],
        "phase2_seconds": res.timings["phase2_seconds"], "edge_cut": q["edge_cut"],
        "comm_volume": q["comm_volume"], "refine_moves": res.telemetry["refine_moves"],
        "max_memory_allocated": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
    }))

    # ------------------------------------------------------------ phase 4
    social_res = res  # phase 11 profiles pagerank on this partition
    social = res.graph
    log(json.dumps({"phase": 4, "dataset": dataset, **profile_stream(torch, tapi, social, device)}))

    # ------------------------------------------------------------ phase 5
    sharded_shapes = sharded_kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer, floor)

    # ------------------------------------------------------------ phase 6
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spec = tapi.PartitionSpec(algo="fennel-parallel", k=8, epsilon=0.05, balance_mode="edge",
                              order="random", seed=0,
                              params={"num_shards": NUM_SHARDS, "max_workers": 0})
    reset_counts(*counters)
    res = tapi.partition(graph, spec, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    sharded_launches = ops.sharded_launches
    check(ops.launches == 0, "the parallel path launched the sequential kernel")
    tel = res.telemetry
    # every superstep of fennel-parallel has candidates
    steps = ShardedStream.from_ids(np.arange(graph.num_vertices), NUM_SHARDS).num_supersteps(CHUNK)
    check(tel["supersteps"] == tel["kernel_calls"] == steps,
          f"supersteps {tel['supersteps']} / kernel_calls {tel['kernel_calls']} != {steps}")
    expect = tel["kernel_calls"] if device.type == "cuda" else 0
    check(sharded_launches == expect,
          f"sharded kernel launched {sharded_launches} times, expected {expect}")
    q = res.quality()
    check_quality(np, graph, res.assignment, q, 8, "fennel-parallel")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    # the same spec on one host thread: the assignment must not change, and
    # the stream time shows what the pool threads buy on this host
    one = tapi.partition(graph, spec.replace(params={"num_shards": NUM_SHARDS, "max_workers": 1}),
                         device=device)
    check(np.array_equal(one.assignment, res.assignment),
          "fennel-parallel: max_workers=1 and max_workers=0 assignments differ")
    log(json.dumps({
        "phase": 6, "algo": "fennel-parallel", "graph": f"rmat 2^{scale} avg_degree 16",
        "num_shards": NUM_SHARDS, "max_workers": tel["max_workers"],
        "edge_cut": q["edge_cut"], "comm_volume": q["comm_volume"],
        "vertex_imbalance": q["vertex_imbalance"], "edge_imbalance": q["edge_imbalance"],
        "stream_seconds": res.timings["stream_seconds"], "total_s": res.timings["total_s"],
        "supersteps": tel["supersteps"], "boundary_conflicts": tel["boundary_conflicts"],
        "kernel_calls": tel["kernel_calls"], "launches": sharded_launches,
        "variant": SCORE_VARIANT, "profile": profile_totals(res.profile),
        "max_memory_allocated": peak,
        "workers1_stream_seconds": one.timings["stream_seconds"],
        "workers1_profile": profile_totals(one.profile), "device": ident,
    }))
    del dgraph, res, one

    # ------------------------------------------------------------ phase 7
    for algo in ("fennel-parallel", "cuttana-parallel", "cuttana-restream"):
        spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                                  params={"num_shards": NUM_SHARDS})
        reset_counts(*counters)
        on_dev = tapi.partition(web, spec, device=device)
        dev_launches = ops.sharded_launches
        check(ops.launches == 0, f"web-s {algo}: the sequential kernel launched")
        expect = on_dev.telemetry["kernel_calls"] if device.type == "cuda" else 0
        check(dev_launches == expect, f"web-s {algo}: {dev_launches} launches, expected {expect}")
        on_cpu = tapi.partition(web, spec, device="cpu")
        check(np.array_equal(on_dev.assignment, on_cpu.assignment),
              f"web-s {algo}: {device.type} and cpu assignments differ")
        for r in (on_dev, on_cpu):
            check(r.quality()["edge_cut"] == WEB_S_EDGE_CUT[algo],
                  f"web-s {algo}: edge_cut {r.quality()['edge_cut']} != {WEB_S_EDGE_CUT[algo]}")
        log(json.dumps({
            "phase": 7, "dataset": "web-s", "algo": algo, "num_shards": NUM_SHARDS,
            "edge_cut": on_dev.quality()["edge_cut"], "identical_to_cpu": True,
            "kernel_calls": on_dev.telemetry["kernel_calls"], "launches": dev_launches,
            "supersteps": on_dev.telemetry.get("supersteps"),
            "boundary_conflicts": on_dev.telemetry.get("boundary_conflicts"),
            "timings_device": on_dev.timings, "timings_cpu": on_cpu.timings,
        }))
    for seq_algo, par_algo in (("fennel", "fennel-parallel"), ("cuttana", "cuttana-parallel")):
        seq = tapi.partition(web, tapi.PartitionSpec(
            algo=seq_algo, k=8, balance_mode="edge", order="random", seed=0), device=device)
        one = tapi.partition(web, tapi.PartitionSpec(
            algo=par_algo, k=8, balance_mode="edge", order="random", seed=0,
            params={"num_shards": 1}), device=device)
        check(np.array_equal(seq.assignment, one.assignment),
              f"web-s {par_algo} at S=1 differs from {seq_algo}")
        log(json.dumps({"phase": 7, "dataset": "web-s", "algo": par_algo, "num_shards": 1,
                        "identical_to": seq_algo, "edge_cut": one.quality()["edge_cut"]}))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    res = tapi.partition(social, tapi.PartitionSpec(
        algo="cuttana-parallel", k=8, balance_mode="edge", order="random", seed=0,
        params={"num_shards": NUM_SHARDS}), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    q = res.quality()
    tel = res.telemetry
    expect = tel["kernel_calls"] if device.type == "cuda" else 0
    check(ops.sharded_launches == expect,
          f"{dataset} cuttana-parallel: {ops.sharded_launches} launches, expected {expect}")
    if not args.tiny:
        check(q["edge_cut"] == SOCIAL_M_CUTTANA_PARALLEL_EDGE_CUT,
              f"social-m cuttana-parallel: edge_cut {q['edge_cut']} != "
              f"{SOCIAL_M_CUTTANA_PARALLEL_EDGE_CUT}")
    log(json.dumps({
        "phase": 7, "dataset": dataset, "algo": "cuttana-parallel", "num_shards": NUM_SHARDS,
        "edge_cut": q["edge_cut"], "comm_volume": q["comm_volume"],
        "phase1_seconds": res.timings["phase1_seconds"],
        "phase2_seconds": res.timings["phase2_seconds"],
        "supersteps": tel["supersteps"], "kernel_calls": tel["kernel_calls"],
        "launches": ops.sharded_launches, "boundary_conflicts": tel["boundary_conflicts"],
        "refine_moves": tel["refine_moves"], "profile": profile_totals(res.profile),
        "max_memory_allocated": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
    }))
    del res

    # ------------------------------------------------------------ phase 8
    log(json.dumps({"phase": 8, "dataset": dataset, **profile_stream(
        torch, tapi, social, device, "fennel-parallel", {"num_shards": NUM_SHARDS})}))

    # ------------------------------------------------------------ phase 9
    lg = main_res.localized()
    t0 = time.perf_counter()
    lg.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    to_device_s = time.perf_counter() - t0
    log(json.dumps({
        "phase": 9, "layout": f"rmat 2^{scale} fennel k=8", "localize_seconds":
        main_res.timings["localize_seconds"], "layout_to_device_seconds": to_device_s,
        "k": lg.k, "v_max": lg.v_max, "h_max": lg.h_max, "e_max": lg.e_max,
        "state_len": lg.state_len, "max_local_edges": lg.max_local_edges(),
    }))
    spmv_shapes = spmv_kernel_checks(torch, np, spmv, spmv_ref, lg, device, timer)

    # ----------------------------------------------------------- phase 10
    q = main_res.quality()
    n = graph.num_vertices
    on_cpu = dataclasses.replace(main_res, device=torch.device("cpu"))  # shares the layout
    spmv_launches = 0
    for prog, iters in ANALYTICS_ITERS.items():
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts(*counters)
        out = main_res.analytics(prog, iters, mode="simulated")
        launches = spmv.launches
        check(ops.launches == 0 and ops.sharded_launches == 0,
              f"analytics {prog}: a partition-score kernel launched")
        expect = iters if device.type == "cuda" else 0
        check(launches == expect, f"analytics {prog}: {launches} launches, expected {expect}")
        spmv_launches += launches
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
        got = out["values"]
        check(got.shape == (n,) and got.dtype == np.float32 and np.isfinite(got).all(),
              f"analytics {prog}: values have the wrong shape, type or non-finite entries")
        short = main_res.analytics(prog, CPU_PARITY_ITERS, mode="simulated")["values"]
        want = on_cpu.analytics(prog, CPU_PARITY_ITERS, mode="simulated")
        if prog == "pagerank":
            check(np.allclose(short, want["values"], rtol=1e-5, atol=1e-9),
                  f"analytics pagerank: {device.type} and cpu values differ beyond rtol 1e-5")
            check((got > 0).all() and got.sum() <= 1.0 + 1e-3, "analytics pagerank: not a distribution")
            again = main_res.analytics(prog, iters, mode="simulated")
            check(np.array_equal(again["values"], got), "analytics pagerank: two runs differ")
        else:
            check(np.array_equal(short, want["values"]),
                  f"analytics {prog}: {device.type} and cpu values differ")
        check(abs(out["halo_messages_per_iter"] - q["comm_volume"] * lg.k * n) < 1e-3,
              f"analytics {prog}: halo messages {out['halo_messages_per_iter']} != "
              f"comm_volume * k * |V| = {q['comm_volume'] * lg.k * n}")
        log(json.dumps({
            "phase": 10, "program": prog, "iters": iters, "launches": launches,
            "seconds": out["seconds"], "cpu_parity_iters": CPU_PARITY_ITERS,
            "cpu_seconds": want["seconds"],
            "localize_seconds": main_res.timings["localize_seconds"],
            "halo_messages_per_iter": out["halo_messages_per_iter"],
            "padded_halo_elements_per_iter": out["padded_halo_elements_per_iter"],
            "max_local_edges": out["max_local_edges"], "mean_local_edges": out["mean_local_edges"],
            "identical_to_cpu": bool(np.array_equal(short, want["values"])),
            "max_rel_diff_to_cpu": float(np.max(np.abs(short - want["values"])
                                                / np.maximum(np.abs(want["values"]), 1e-30))),
            "second_run_seconds": again["seconds"] if prog == "pagerank" else None,
            "max_memory_allocated": peak, "device": ident,
        }))
    # a small input against the float64 dense oracles (tests/test_analytics.py's tolerances)
    web_res = tapi.partition(web, tapi.PartitionSpec(algo="fennel", k=8, balance_mode="edge",
                                                     order="random", seed=0), device=device)
    pr = web_res.analytics("pagerank", 30, mode="simulated")["values"]
    check(np.allclose(pr, programs.reference_pagerank(web, 30), rtol=2e-4, atol=1e-9),
          "web-s pagerank differs from the float64 oracle")
    cc = web_res.analytics("cc", 20, mode="simulated")["values"]
    check(np.array_equal(cc, programs.reference_cc(web, 20)), "web-s cc differs from the oracle")
    sp = web_res.analytics("sssp", 20, mode="simulated")["values"]
    want = programs.reference_sssp(web, 20)
    finite = np.isfinite(want)
    check(np.array_equal(sp[finite], want[finite]) and (sp[~finite] > 1e30).all(),
          "web-s sssp differs from the oracle")
    log(json.dumps({"phase": 10, "dataset": "web-s", "oracles_agree": True}))

    # ----------------------------------------------------------- phase 11
    social_res.localized().to(device)  # layout built and placed outside the profile
    log(json.dumps({"phase": 11, "dataset": dataset, **profile_analytics(
        torch, social_res, spmv, device)}))

    # ------------------------------------------------------ phases 18-20
    del lg, on_cpu
    main_res._localized = None  # the analytics layout of phases 9-10
    zoo_paths, zoo_rows = zoo_phases(torch, np, tapi, ops, ref, counters, device, timer, floor,
                                     web, social, graph, dataset, args.tiny, ident)

    # ----------------------------------------------------------- phase 21
    rows_shapes, rows_launches = outofcore_phase(
        torch, np, tapi, ops, ref, counters, device, timer, floor, graph, main_res, main_peak,
        main_rss, args.tiny, ident)

    # ----------------------------------------------------------- phase 22
    serving_row, serving_launches = serving_phase(
        torch, np, tapi, ops, ref, counters, device, timer, floor, graph, main_res, args.tiny,
        ident)

    # ----------------------------------------------------------- phase 12
    del graph, main_res, social_res, social, web_res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    import torch.nn.functional as F

    flash_shapes = flash_kernel_checks(torch, np, F, fa, fa_ref, timer, args.tiny)
    decode_shapes = [r for r in flash_shapes if r["variant"] == "decode_split"]

    # ----------------------------------------------------------- phase 13
    scan_shapes = scan_kernel_checks(torch, scan, scan_ref, timer, args.tiny)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------ phases 14, 15
    lm_launches = {"flash_attention": 0, "selective_scan": 0}
    flash_variants = dict.fromkeys(fa.VARIANTS, 0)
    for phase, arch in zip((14, 15), LM_ARCHS):
        rec, model, params = lm_phase(torch, np, counters, device, arch, args.tiny, ident)
        for path in ("prefill", "serve"):
            for name, n in rec[path]["launches"].items():
                lm_launches[name] += n
            for name, n in rec[path]["flash_variants"].items():
                flash_variants[name] += n
        log(json.dumps({"phase": phase, **rec}))
        if arch == "qwen3-8b":
            # ------------------------------------------------------- phase 17
            long_rec = long_decode_phase(torch, np, counters, device, model, params, args.tiny,
                                         ident)
            log(json.dumps({"phase": 17, **long_rec}))
        del model, params
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- phase 16
    reduced_parity(torch, np, device)

    # ------------------------------------------------------------ summary
    def stream_summary(row):
        return {key: row[key] for key in ("shape", "launches", "total_ms", "ms", "slowest_ms",
                                          "floor_ms", "bound_ms")}

    def summary(name, shapes_, launches, replaces, source=KERNEL_SOURCE, **extra):
        main_shape = shapes_[0]
        err = max(r.get("max_abs_err", max(r.get("max_abs_err_alpha0", 0.0),
                                           r.get("max_abs_err_penalty", 0.0))) for r in shapes_)
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": main_shape["ms"], "call_ms": main_shape["call_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"], **extra,
        }

    # the zoo's kernel shapes (phases 1 and 19): 4,096-row chunks, a sampled
    # dense matrix, the longest coarse row's chunk; and phase 22's chunk of
    # the served cuttana stream
    zoo_shapes = [{key: row[key] for key in (
        "shape", "rows", "max_row", "ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
        "floor_ms", "split_rows") if key in row}
        for row in [r for r in shapes if r["shape"].startswith(("chunk4096", "dense_sampled"))]
        + zoo_rows + [serving_row]]
    log(json.dumps({"kernels": [
        summary("partition_score", shapes + zoo_rows + [serving_row], main_launches,
                TPU_KERNEL, variant=SCORE_VARIANT, floor_ms=shapes[0]["floor_ms"],
                stream=stream_summary(shapes[-1]), zoo_shapes=zoo_shapes,
                zoo_launches={path: n[0] for path, n in zoo_paths.items() if n[0]},
                serving_launches=serving_launches),
        summary("partition_score_sharded", sharded_shapes, sharded_launches, TPU_KERNEL_SHARDED,
                variant=SCORE_VARIANT, floor_ms=sharded_shapes[0]["floor_ms"],
                stream=stream_summary(sharded_shapes[-1]),
                zoo_launches={path: n[1] for path, n in zoo_paths.items() if n[1]}),
        # the rows entries: the same kernel on a memory-mapped graph's
        # chunks (phase 21's full-size fennel) and supersteps (its
        # cuttana-parallel), at phase 21's mapped shapes
        summary("partition_score_rows", rows_shapes[:1], rows_launches["rows"], TPU_KERNEL,
                variant=SCORE_VARIANT, entry="fennel_scores_rows",
                floor_ms=rows_shapes[0]["floor_ms"], copy_ms=rows_shapes[0]["copy_ms"],
                packed_bytes=rows_shapes[0]["packed_bytes"]),
        summary("partition_score_sharded_rows", rows_shapes[1:], rows_launches["sharded_rows"],
                TPU_KERNEL_SHARDED, variant=SCORE_VARIANT, entry="fennel_scores_sharded_rows",
                floor_ms=rows_shapes[1]["floor_ms"], copy_ms=rows_shapes[1]["copy_ms"],
                packed_bytes=rows_shapes[1]["packed_bytes"]),
        summary("ell_spmv", spmv_shapes, spmv_launches, TPU_KERNEL_SPMV, SPMV_SOURCE,
                variant=SPMV_VARIANT, gb_per_s=spmv_shapes[0]["gb_per_s"]),
        summary("flash_attention", flash_shapes, lm_launches["flash_attention"],
                TPU_KERNEL_FLASH, FLASH_SOURCE, variant=flash_shapes[0]["variant"],
                tflops=flash_shapes[0]["tflops"], variant_launches=flash_variants),
        # the decode variant on its own: phase 17's long-context decode is its main
        # path, and its timed shape is phase 12's layer at phase 17's batch (B=8)
        summary("flash_attention_decode_split", decode_shapes,
                long_rec["flash_variants"]["decode_split"], TPU_KERNEL_FLASH, FLASH_SOURCE,
                variant="decode_split", shape=decode_shapes[0]["shape"],
                n_split=decode_shapes[0]["n_split"], main_path_n_split=long_rec["n_split"],
                tb_per_s=decode_shapes[0]["bytes"] / decode_shapes[0]["ms"] / 1e9,
                second_shape={key: decode_shapes[1].get(key) for key in (
                    "shape", "n_split", "ms", "bound_ms", "library_ms", "plain_ms")}),
        summary("selective_scan", scan_shapes, lm_launches["selective_scan"],
                TPU_KERNEL_SCAN, SCAN_SOURCE, variant=scan_shapes[0]["variant"],
                exp_bound_share=scan_shapes[0]["exp_bound_share"]),
    ]}))
    if args.tiny:
        log("tiny rehearsal finished on the CPU: every phase ran; no device result")
        return 0
    log(gpu_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
