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
     its idle share, and the kernel's device time per launch.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
CHUNK = 512
# the reference's values for these specs (repro.api.partition, k=8, edge
# balance, random order, seed 0)
WEB_S_EDGE_CUT = {"fennel": 0.6510985792934956, "cuttana": 0.5606603189477736}
SOCIAL_M_CUTTANA_EDGE_CUT = 0.8217978285092379


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


def profile_stream(torch, tapi, graph, device) -> dict:
    """Phase 4: ``fennel`` on ``graph`` under ``torch.profiler``: how much
    of the run the card is busy, and with what. Device events are summed
    by name (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    spec = tapi.PartitionSpec(algo="fennel", k=8, balance_mode="edge", order="random", seed=0)
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
        "algo": "fennel", "num_vertices": graph.num_vertices,
        "kernel_calls": res.telemetry["kernel_calls"],
        "profiled_wall_s": wall, "stream_seconds": res.timings["stream_seconds"],
        "device_busy_s": busy_us / 1e6 if on_card else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if on_card else None,
        "kernel_events": kernel_n if on_card else None,
        "kernel_device_ms_total": kernel_us / 1e3 if on_card else None,
        "kernel_device_ms_per_launch": kernel_us / 1e3 / kernel_n if kernel_n else None,
        "top_device_events_ms": [[k[:80], us / 1e3, n] for k, (us, n) in top],
    }


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
    ops.launches = 0
    res = tapi.partition(graph, spec, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    main_launches = ops.launches
    q = res.quality()
    chunks = -(-graph.num_vertices // CHUNK)
    expect_launches = chunks if device.type == "cuda" else 0
    check(res.telemetry["kernel_calls"] == chunks,
          f"kernel_calls {res.telemetry['kernel_calls']} != {chunks} chunks")
    check(main_launches == expect_launches,
          f"kernel launched {main_launches} times on the main path, expected {expect_launches}")
    part = res.assignment
    check(part.shape == (graph.num_vertices,) and part.min() >= 0 and part.max() < 8,
          "assignment has the wrong shape or ids")
    # the device quality scan against a host recomputation
    src = np.repeat(np.arange(graph.num_vertices, dtype=np.int64), graph.degrees)
    host_cut = int((part[src] != part[graph.indices]).sum()) // 2 / graph.num_edges
    del src
    check(q["edge_cut"] == host_cut, f"device edge_cut {q['edge_cut']} != host {host_cut}")
    e_mass = np.bincount(part, weights=graph.degrees.astype(np.float64), minlength=8)
    check(q["edge_imbalance"] == float(e_mass.max() / e_mass.mean()), "edge imbalance differs from host")
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
    del graph, dgraph, res, part

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
    log(json.dumps({"phase": 4, "dataset": dataset, **profile_stream(torch, tapi, res.graph, device)}))

    # ------------------------------------------------------------ summary
    main_shape = shapes[0]
    log(json.dumps({"kernels": [{
        "name": "partition_score", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": main_launches,
        "max_abs_err": max(max(r["max_abs_err_alpha0"], r["max_abs_err_penalty"]) for r in shapes),
        "ms": main_shape["ms"], "call_ms": main_shape["call_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]}))
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
