#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py           # on a machine with one CUDA card
    python3 chip_smoke.py --tiny    # CPU rehearsal at a tiny size (no result)

Phases:
  0. set-up: card name and power limit, torch/CUDA versions, kernel build;
  1. the partition-score kernel against its plain PyTorch version on the card
     at the main path's shapes (C=512 chunks of the phase-2 graph at K=8 and
     K=64, the chunk holding the highest-degree vertex, the dense entry),
     exact at alpha=0 and within 1e-6 with a penalty, timed with CUDA events
     beside the plain version and one ``torch.bincount`` (``library_ms``);
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
     at alpha=0 and within 1e-6 with a penalty, timed like phase 1;
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
     card's busy time and idle share, beside phase 4's sequential stream.

Kernel times: ``ms`` is device time per launch (launches captured in a CUDA
graph and replayed, so the host's cost of a call is out); ``call_ms``,
``plain_ms`` and ``library_ms`` are per call back to back on the stream, host
cost included (the plain version and ``torch.bincount`` synchronise, so they
cannot be captured).

The last lines are the ``{"kernels": [...]}`` summary, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line. Without a CUDA device (and without ``--tiny``)
the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/partition_score/csrc/partition_score.cu"
TPU_KERNEL = "src/repro/kernels/partition_score/partition_score.py:105"
TPU_KERNEL_SHARDED = "src/repro/kernels/partition_score/partition_score.py:68"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
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
SOCIAL_M_CUTTANA_EDGE_CUT = 0.8217978285092379
SOCIAL_M_CUTTANA_PARALLEL_EDGE_CUT = 0.7972897394038334


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
            return self(fn)
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


def kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer):
    """Phase 1: kernel vs plain version at the main path's shapes."""
    rng = np.random.default_rng(0)
    n = graph.num_vertices
    order = rng.permutation(n)
    hub = int(graph.degrees.argmax())
    gather_shapes = [
        ("chunk512_k8", order[:CHUNK], 8),
        ("chunk512_k64", order[CHUNK : 2 * CHUNK], 64),
        ("chunk512_hub_k8", np.concatenate([[hub], order[2 * CHUNK : 3 * CHUNK - 1]]), 8),
    ]
    rows_out = []
    for name, batch, k in gather_shapes:
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
        if device.type == "cuda":
            torch.cuda.synchronize()
        err0 = float((got0 - want0).abs().max())
        err1 = float((got1 - want1).abs().max())
        check(err0 == 0.0, f"{name}: kernel differs from plain version at alpha=0 ({err0})")
        check(err1 <= 1e-6, f"{name}: kernel differs from plain version with penalty ({err1})")
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
        rows_out.append({
            "shape": name, "rows": c, "k": k, "nnz": nnz,
            "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
            "ms": timer.device_ms(lambda: ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)),
            "call_ms": timer(lambda: ops.fennel_scores_gather(*args, zeros, 0.0, 1.5)),
            "plain_ms": timer(lambda: ref.fennel_scores_gather_ref(*args, zeros, 0.0, 1.5)),
            "library_ms": timer(lambda: torch.bincount(keys, minlength=c * k)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        })
    # the dense entry (the JAX signature)
    bsz, d, k = 200, 100, 16
    nbr = torch.from_numpy(rng.integers(-1, k, size=(bsz, d)).astype(np.int32)).to(device)
    zeros = torch.zeros(k, dtype=torch.float32, device=device)
    sizes = torch.from_numpy((rng.random(k) * 100).astype(np.float32)).to(device)
    err0 = float((ops.fennel_scores(nbr, zeros, 0.0) - ref.fennel_scores_ref(nbr, zeros, 0.0, 1.5)).abs().max())
    err1 = float((ops.fennel_scores(nbr, sizes, 0.37, 1.5) - ref.fennel_scores_ref(nbr, sizes, 0.37, 1.5)).abs().max())
    check(err0 == 0.0, f"dense: kernel differs from plain version at alpha=0 ({err0})")
    check(err1 <= 1e-6, f"dense: kernel differs from plain version with penalty ({err1})")
    flat = nbr.reshape(-1).long()
    keep = flat >= 0
    keys = (torch.arange(bsz, device=device).repeat_interleave(d)[keep] * k + flat[keep])
    rows_out.append({
        "shape": "dense200x100_k16", "rows": bsz, "k": k, "nnz": bsz * d,
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "ms": timer.device_ms(lambda: ops.fennel_scores(nbr, sizes, 0.37, 1.5)),
        "call_ms": timer(lambda: ops.fennel_scores(nbr, sizes, 0.37, 1.5)),
        "plain_ms": timer(lambda: ref.fennel_scores_ref(nbr, sizes, 0.37, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=bsz * k)),
        "bound_ms": (bsz * d * 4 + k * 4 + bsz * k * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    })
    for row in rows_out:
        log(json.dumps({"phase": 1, **row}))
    return rows_out


def profile_stream(torch, tapi, graph, device, algo="fennel", params=None) -> dict:
    """Phases 4 and 8: ``algo`` on ``graph`` under ``torch.profiler``: how
    much of the run the card is busy, and with what. Device events are summed
    by name (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
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
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            slot = by_name.setdefault(e.name, [0.0, 0])
            slot[0] += e.time_range.elapsed_us()
            slot[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    kernel = [v for k, v in by_name.items() if "score_kernel" in k]
    kernel_us = sum(us for us, _ in kernel)
    kernel_n = sum(n for _, n in kernel)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "algo": algo, "params": params, "num_vertices": graph.num_vertices,
        "kernel_calls": res.telemetry["kernel_calls"],
        "profiled_wall_s": wall, "stream_seconds": res.timings["stream_seconds"],
        "device_busy_s": busy_us / 1e6 if on_card else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if on_card else None,
        "kernel_events": kernel_n if on_card else None,
        "kernel_device_ms_total": kernel_us / 1e3 if on_card else None,
        "kernel_device_ms_per_launch": kernel_us / 1e3 / kernel_n if kernel_n else None,
        "top_device_events_ms": [[k[:80], us / 1e3, n] for k, (us, n) in top],
    }


def sharded_kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer):
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
            "shape": name, "shards": s, "superstep": step, "rows": c, "k": k, "nnz": nnz,
            "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
            "ms": timer.device_ms(lambda: ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)),
            "call_ms": timer(lambda: ops.fennel_scores_sharded_gather(*args, zeros, 0.0, 1.5)),
            "plain_ms": timer(lambda: ref.fennel_scores_sharded_gather_ref(*args, zeros, 0.0, 1.5)),
            "library_ms": timer(lambda: torch.bincount(keys, minlength=c * k)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
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
        "shape": f"dense{s}x{c}x{d}_k{k}", "shards": s, "rows": s * c, "k": k, "nnz": s * c * d,
        "max_abs_err_alpha0": err0, "max_abs_err_penalty": err1,
        "ms": timer.device_ms(lambda: ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)),
        "call_ms": timer(lambda: ops.fennel_scores_sharded(nbr, sizes, 0.37, 1.5)),
        "plain_ms": timer(lambda: ref.fennel_scores_sharded_ref(nbr, sizes, 0.37, 1.5)),
        "library_ms": timer(lambda: torch.bincount(keys, minlength=s * c * k)),
        "bound_ms": (s * c * d * 4 + s * k * 4 + s * c * k * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    })
    for row in rows_out:
        log(json.dumps({"phase": 5, **row}))
    return rows_out


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


def reset_counts(ops) -> None:
    ops.launches = 0
    ops.sharded_launches = 0


def profile_totals(profile: dict) -> dict:
    """The parallel engine's profile without its per-superstep rows."""
    return {k: v for k, v in profile.items() if k != "per_superstep"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="rehearse every phase on the CPU at a tiny size (prints no result)")
    args = ap.parse_args()

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
    import repro_torch.api as tapi
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.graph.stream import ShardedStream
    from repro_torch.kernels.partition_score import build, ops, ref

    device = torch.device("cpu" if args.tiny else "cuda")
    timer = Timer(torch, device)

    # ------------------------------------------------------------ phase 0
    ident = "cpu rehearsal" if args.tiny else gpu_identity()
    log(f"phase 0: {ident} | torch {torch.__version__} | cuda {torch.version.cuda}")
    if not args.tiny:
        t0 = time.perf_counter()
        build.build()
        build.library()
        log(f"phase 0: kernel built in {time.perf_counter() - t0:.3f} s "
            f"(nvcc {build.build_seconds:.3f} s)")
        for line in build.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"phase 0: ptxas: {line.strip()}")

    # ------------------------------------------------------------ phase 1
    scale = 14 if args.tiny else 22
    t0 = time.perf_counter()
    graph = rmat_graph(1 << scale, avg_degree=16, seed=0)
    log(f"phase 1: rmat 2^{scale} generated in {time.perf_counter() - t0:.3f} s: "
        f"{graph.num_vertices} vertices, {graph.num_edges} edges, "
        f"max degree {int(graph.degrees.max())}")
    dgraph = graph.to(device)
    shapes = kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer)

    # ------------------------------------------------------------ phase 2
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spec = tapi.PartitionSpec(algo="fennel", k=8, epsilon=0.05, balance_mode="edge",
                              order="random", seed=0)
    reset_counts(ops)
    res = tapi.partition(graph, spec, device=device)
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
        "max_memory_allocated": peak, "device": ident,
    }))
    del res

    # ------------------------------------------------------------ phase 3
    from repro_torch.graph.generators import load_dataset

    web = load_dataset("web-s", seed=0)
    for algo in ("fennel", "cuttana"):
        spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0)
        ops.launches = 0
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
    social = res.graph
    del res
    log(json.dumps({"phase": 4, "dataset": dataset, **profile_stream(torch, tapi, social, device)}))

    # ------------------------------------------------------------ phase 5
    sharded_shapes = sharded_kernel_checks(torch, np, ops, ref, dgraph, graph, device, timer)

    # ------------------------------------------------------------ phase 6
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spec = tapi.PartitionSpec(algo="fennel-parallel", k=8, epsilon=0.05, balance_mode="edge",
                              order="random", seed=0,
                              params={"num_shards": NUM_SHARDS, "max_workers": 0})
    reset_counts(ops)
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
        "profile": profile_totals(res.profile), "max_memory_allocated": peak,
        "workers1_stream_seconds": one.timings["stream_seconds"],
        "workers1_profile": profile_totals(one.profile), "device": ident,
    }))
    del graph, dgraph, res, one

    # ------------------------------------------------------------ phase 7
    for algo in ("fennel-parallel", "cuttana-parallel", "cuttana-restream"):
        spec = tapi.PartitionSpec(algo=algo, k=8, balance_mode="edge", order="random", seed=0,
                                  params={"num_shards": NUM_SHARDS})
        reset_counts(ops)
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
    reset_counts(ops)
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

    # ------------------------------------------------------------ summary
    def summary(name, shapes_, launches, replaces):
        main_shape = shapes_[0]
        return {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(max(r["max_abs_err_alpha0"], r["max_abs_err_penalty"])
                               for r in shapes_),
            "ms": main_shape["ms"], "call_ms": main_shape["call_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
        }

    log(json.dumps({"kernels": [
        summary("partition_score", shapes, main_launches, TPU_KERNEL),
        summary("partition_score_sharded", sharded_shapes, sharded_launches, TPU_KERNEL_SHARDED),
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
