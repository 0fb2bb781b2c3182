#!/usr/bin/env python3
"""Where the partition-score kernel spends its time, on one CUDA card.

Builds ``src/repro_torch/kernels/partition_score/csrc/partition_score.cu`` as
it is, with one constant or its counting changed, beside the first port's
block-per-row kernel and an empty kernel, and times them at the shapes
``chip_smoke.py`` times (phases 1 and 5) on an R-MAT of 2^22 vertices
(``--scale``), average degree 16, seed 0, k=8 unless named:

    cluster<n>    n blocks a cluster sharing one group's path; the kernel's
                  own value is marked "kernel"
    threads<n>    blocks of n threads (and groups of at most n rows)
    unroll<n>     n path items a thread in flight
    whole<n>      rows of at most n items never split (the kernel: 4,096)
    no_snap       every share bound where path * b / blocks falls, so short
                  rows are split too (and nearly every cluster takes its
                  barriers)
    count_ballot  warp counting where a warp's lanes share one row (a
                  ballot per partition, K <= 32), atomics elsewhere
    count_match   __match_any_sync, one atomic per distinct (row, partition)
                  of a warp (the kernel: one shared-memory atomic an entry)
    cut_*         cut-down kernels (they compute garbage; only their times
                  mean anything): cut_prologue stops once the group's path
                  and the shares are known, cut_loads reads no indices or
                  part_of, cut_epilogue writes no scores
    row_block     the first port's kernel: one block of 256 threads a row,
                  shared-memory atomics (kept here for the record)
    floor         an empty kernel launched with the kernel's grid, block,
                  cluster and shared memory: the launch alone

Shapes: ``chunk512_k8``, ``chunk512_k64``, ``chunk512_hub_k8`` (the hub's
97,599 entries among 511 short rows), ``superstep_s4_k8``,
``superstep_hub_s4_k8``, ``superstep_s4_k64`` (one superstep at S=4 of the
random stream order), and ``stream8192_k8`` / ``superstep_stream_s4_k8``:
every chunk (superstep) of the random order, each launch on its own slice,
captured in one CUDA graph. A shape's ``ms`` is the mean device time of a
launch: 100 launches captured in a graph and replayed (``graph_ms``); a
stream's is its total over its launches, and ``slowest_ms`` the slowest
launch, timed by external events between the launches in a second graph
(``stream_times``). Each row names the card and its power limit. Run from
the repository root on a machine with the card and the CUDA toolkit:

    python3 scripts/kernel_ablation_partition_score.py [--scale 22] [--no-streams]

``chip_smoke.py`` imports ``floor_library``, ``floor_call``,
``launch_shape`` and ``stream_times`` from here for its launch-floor and
stream rows.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/partition_score/csrc/partition_score.cu"
OUT = ROOT / "build" / "ablation"
CHUNK = 512

# An empty kernel launched at a given grid, block, cluster size and dynamic
# shared memory: what a launch costs with nothing to do.
FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
namespace {
__global__ void empty_kernel() {}
}
extern "C" int score_floor_launch(int blocks, int threads, int smem, int cluster, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel));
}
"""
FLOOR_SIGNATURES = {"score_floor_launch": [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]}

# The first port's kernel (PRs 11-18), gather entries only: one block of 256
# threads a row walks the row's CSR entries at a stride of 256 and counts
# with shared-memory atomics into K counters.
ROW_BLOCK_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
namespace {
struct GatherRows {
  const int64_t* indptr; const int32_t* indices; const int32_t* part_of; const int64_t* batch;
  __device__ void range(int r, int64_t& b, int64_t& e) const { const int64_t v = batch[r]; b = indptr[v]; e = indptr[v + 1]; }
  __device__ int part(int64_t j) const { return part_of[indices[j]]; }
  __device__ int size_row(int) const { return 0; }
};
struct ShardedGatherRows {
  const int64_t* indptr; const int32_t* indices; const int32_t* part_of; const int64_t* batch;
  const int64_t* shard_start; int num_shards;
  __device__ void range(int r, int64_t& b, int64_t& e) const { const int64_t v = batch[r]; b = indptr[v]; e = indptr[v + 1]; }
  __device__ int part(int64_t j) const { return part_of[indices[j]]; }
  __device__ int size_row(int r) const {
    int lo = 0, hi = num_shards - 1;
    while (lo < hi) { const int mid = (lo + hi + 1) / 2; if (shard_start[mid] <= r) lo = mid; else hi = mid - 1; }
    return lo;
  }
};
template <class Rows>
__global__ void __launch_bounds__(256) score_kernel(Rows rows, const float* sizes, int k, float ag, float gm1, float* out) {
  extern __shared__ int counts[];
  const int r = blockIdx.x;
  for (int p = threadIdx.x; p < k; p += blockDim.x) counts[p] = 0;
  __syncthreads();
  int64_t begin, end;
  rows.range(r, begin, end);
  for (int64_t j = begin + threadIdx.x; j < end; j += blockDim.x) {
    const int p = rows.part(j);
    if (p >= 0 && p < k) atomicAdd(&counts[p], 1);
  }
  __syncthreads();
  const float* s = sizes + static_cast<int64_t>(rows.size_row(r)) * k;
  float* o = out + static_cast<int64_t>(r) * k;
  for (int p = threadIdx.x; p < k; p += blockDim.x) {
    const float size = fmaxf(s[p], 0.0f);
    const float pw = gm1 == 0.5f ? sqrtf(size) : powf(size, gm1);
    o[p] = __fsub_rn(static_cast<float>(counts[p]), __fmul_rn(ag, pw));
  }
}
template <class Rows>
int launch(Rows rows, int n, const float* sizes, int k, float ag, float gm1, float* out, void* stream) {
  score_kernel<Rows><<<n, 256, k * sizeof(int), static_cast<cudaStream_t>(stream)>>>(rows, sizes, k, ag, gm1, out);
  return static_cast<int>(cudaGetLastError());
}
}
extern "C" {
int partition_score_gather(const int64_t* indptr, const int32_t* indices, const int32_t* part_of,
                           const int64_t* batch, int n, const float* sizes, int k, float ag,
                           float gm1, float* out, void* stream) {
  return launch(GatherRows{indptr, indices, part_of, batch}, n, sizes, k, ag, gm1, out, stream);
}
int partition_score_sharded_gather(const int64_t* indptr, const int32_t* indices, const int32_t* part_of,
                                   const int64_t* batch, const int64_t* shard_start, int num_shards,
                                   int n, const float* sizes, int k, float ag, float gm1, float* out,
                                   void* stream) {
  return launch(ShardedGatherRows{indptr, indices, part_of, batch, shard_start, num_shards}, n,
                sizes, k, ag, gm1, out, stream);
}
}
"""

# exact lines of the kernel source (from the line break before) and what
# each variant puts in their place
THREADS = "\nconstexpr int kThreads = 512;"
CLUSTER = "\nconstexpr int kClusterBlocks = 16;"
UNROLL = "\nconstexpr int kUnroll = 4;"
WHOLE = "\nconstexpr int kWholeRow = 4096;"
COUNT = "\n      if (part[u] >= 0 && part[u] < k) atomicAdd(&counts[row[u] * k + part[u]], 1);"
KERNEL_HEAD = "\ntemplate <class Rows>\n__global__ void __cluster_dims__"
WALK = "\n  for (int64_t q = 0; q < per; q += kUnroll) {"
WALK_END = "\n  __syncthreads();  // this block's counts are complete"
# warp counting: a ballot per partition where every counting lane of the
# warp is in one row (lane p keeps partition p's count of that row until the
# warp's row changes), one atomic a lane otherwise; k <= 32 only
BALLOT = r"""
struct BallotCounter {
  int cur = -1, acc = 0;
  __device__ void flush(int* counts, int k, int lane) {
    if (cur >= 0 && lane < k && acc != 0) atomicAdd(&counts[cur * k + lane], acc);
    acc = 0;
  }
  __device__ void add(int* counts, int k, int lane, int row, int p) {
    const unsigned live = __ballot_sync(kFullMask, row >= 0);
    if (live == 0) return;
    const int r0 = __shfl_sync(kFullMask, row, __ffs(live) - 1);
    if (__all_sync(kFullMask, row < 0 || row == r0)) {
      if (r0 != cur) { flush(counts, k, lane); cur = r0; }
      for (int q = 0; q < k; ++q) {
        const unsigned m = __ballot_sync(kFullMask, p == q) & live;
        if (lane == q) acc += __popc(m);
      }
    } else if (row >= 0) {
      atomicAdd(&counts[row * k + p], 1);
    }
  }
};
"""
VARIANTS = {
    "cluster16": [],
    "cluster8": [(CLUSTER, "\nconstexpr int kClusterBlocks = 8;")],
    "threads1024": [(THREADS, "\nconstexpr int kThreads = 1024;")],
    "threads256": [(THREADS, "\nconstexpr int kThreads = 256;")],
    "unroll2": [(UNROLL, "\nconstexpr int kUnroll = 2;")],
    "unroll8": [(UNROLL, "\nconstexpr int kUnroll = 8;")],
    "whole2048": [(WHOLE, "\nconstexpr int kWholeRow = 2048;")],
    "whole16384": [(WHOLE, "\nconstexpr int kWholeRow = 16384;")],
    "no_snap": [("\n    const bool whole = e - s0 < kWholeRow;", "\n    const bool whole = false;")],
    "count_ballot": [(KERNEL_HEAD, "\n" + BALLOT + KERNEL_HEAD),
                     (WALK, "\n  BallotCounter counter;" + WALK),
                     (COUNT, "\n      const bool counted = part[u] >= 0 && part[u] < k;"
                             "\n      counter.add(counts, k, lane, counted ? row[u] : -1, part[u]);"),
                     (WALK_END, "\n  counter.flush(counts, k, lane);" + WALK_END)],
    "count_match": [(COUNT, "\n      const int key_u = part[u] >= 0 && part[u] < k ? row[u] * k + part[u] : -1;"
                            "\n      const unsigned peers = __match_any_sync(kFullMask, key_u);"
                            "\n      if (key_u >= 0 && lane == __ffs(peers) - 1) atomicAdd(&counts[key_u], __popc(peers));")],
    # cut-down kernels: they compute garbage; only their times mean anything
    "cut_prologue": [("\n  const int64_t d0 = bound[rank], d1 = bound[rank + 1];",
                      "\n  if (bound[rank] == -7) out[0] = 1.0f;\n  return;"
                      "\n  const int64_t d0 = bound[rank], d1 = bound[rank + 1];")],
    "cut_loads": [("\n    for (int u = 0; u < kUnroll; ++u) key[u] = row[u] >= 0 ? rows.key(at[u]) : 0;",
                   "\n    for (int u = 0; u < kUnroll; ++u) key[u] = static_cast<int>(at[u] & 7);"),
                  ("\n    for (int u = 0; u < kUnroll; ++u) part[u] = row[u] >= 0 ? rows.part(key[u]) : -1;",
                   "\n    for (int u = 0; u < kUnroll; ++u) part[u] = row[u] >= 0 ? key[u] : -1;")],
    "cut_epilogue": [("\n  // the scores of the rows whose end item lies in this share",
                      "\n  if (counts[0] == -7) out[0] = 1.0f;\n  return;"
                      "\n  // the scores of the rows whose end item lies in this share")],
}
KERNEL = "cluster16"


def edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ablation: the source no longer has exactly one {old.strip()!r}")
        text = text.replace(old, new)
    return text


def build(name: str, text: str) -> Path:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.nvcc import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"ablation: nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def floor_library() -> ctypes.CDLL:
    """The empty kernel's library, built into ``build/ablation``."""
    return load(build("score_floor", FLOOR_SOURCE), FLOOR_SIGNATURES)


def launch_shape(num_rows: int, k: int, width: int | None = None) -> tuple[int, int, int, int]:
    """(blocks, threads, dynamic shared-memory bytes, cluster blocks) of the
    kernel's launch for ``num_rows`` rows at ``k`` (its ``launch``)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.partition_score import ops

    g = ops.group_rows(num_rows, k, width)
    return -(-num_rows // g) * ops.CLUSTER_BLOCKS, ops.THREADS, g * (20 + 4 * k), ops.CLUSTER_BLOCKS


def floor_call(torch, lib, shape) -> callable:
    """A call of the empty kernel at ``shape`` (from :func:`launch_shape`) on
    the current stream; raises on a launch error."""
    blocks, threads, smem, cluster = shape

    def call():
        err = lib.score_floor_launch(blocks, threads, smem, cluster,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
    return call


def graph_ms(torch, fn, reps: int = 100, replays: int = 5) -> float:
    """Mean device ms of ``fn()``: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times."""
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def stream_times(torch, calls, replays: int = 3) -> tuple[dict, list]:
    """Device time of a stream of launches (``calls``, each a function that
    launches once and returns its output), each captured once in one CUDA
    graph: ``total_ms`` (the graph's mean replay time), ``mean_ms`` a launch,
    and ``slowest_ms`` / ``slowest`` from a second graph with an external
    timing event between every two launches, on its second replay (each of
    its times includes the gap to the next launch). Returns the times and
    the first graph's outputs after its last replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for call in calls]
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    total = start.elapsed_time(end) / replays
    events = [torch.cuda.Event(enable_timing=True, external=True) for _ in range(len(calls) + 1)]
    timed = torch.cuda.CUDAGraph()
    with torch.cuda.graph(timed):
        for ev, call in zip(events, calls):
            ev.record()
            call()
        events[-1].record()
    for _ in range(2):  # the events keep the second replay's times: the first warms up
        timed.replay()
        torch.cuda.synchronize()
    each = [events[i].elapsed_time(events[i + 1]) for i in range(len(calls))]
    slowest = max(range(len(each)), key=each.__getitem__)
    del timed
    return {"total_ms": total, "mean_ms": total / len(calls), "slowest_ms": each[slowest],
            "slowest": slowest, "timed_total_ms": sum(each)}, outs


def shapes(np, torch, graph, dgraph):
    """The timed shapes: (name, kind, batch rows (device), shard_start or
    None, k, part_of (device)), and the two streams as lists of slices."""
    from repro_torch.graph.stream import ShardedStream, stream_order

    rng = np.random.default_rng(0)
    n = graph.num_vertices
    order = rng.permutation(n)
    hub = int(graph.degrees.argmax())
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).cuda()  # noqa: E731

    def parts(k):
        p = rng.integers(0, k, size=n).astype(np.int32)
        p[rng.random(n) < 0.3] = -1
        return torch.from_numpy(p).cuda()

    out = [
        ("chunk512_k8", dev(order[:CHUNK]), None, 8, parts(8)),
        ("chunk512_k64", dev(order[CHUNK: 2 * CHUNK]), None, 64, parts(64)),
        ("chunk512_hub_k8", dev(np.concatenate([[hub], order[2 * CHUNK: 3 * CHUNK - 1]])), None, 8,
         parts(8)),
    ]
    ids = stream_order(graph, "random", 0)
    s4 = ShardedStream.from_ids(ids, 4)
    hub_shard = int(np.flatnonzero(ids == hub)[0]) % 4
    t_hub = int(np.flatnonzero(s4.shards[hub_shard] == hub)[0]) // CHUNK
    steps = s4.num_supersteps(CHUNK)
    packed, starts = [], []
    for t in range(steps):
        batches = [sh[t * CHUNK: (t + 1) * CHUNK] for sh in s4.shards]
        packed.append(np.concatenate(batches))
        starts.append(np.concatenate([[0], np.cumsum([b.shape[0] for b in batches])]))
    for name, t, k in (("superstep_s4_k8", 0, 8), ("superstep_hub_s4_k8", t_hub, 8),
                       ("superstep_s4_k64", 1, 64)):
        out.append((name, dev(packed[t]), dev(starts[t]), k, parts(k)))
    streams = {
        "stream8192_k8": (dev(ids), [(i * CHUNK, min(n, (i + 1) * CHUNK))
                                     for i in range(-(-n // CHUNK))], None),
        "superstep_stream_s4_k8": (dev(np.concatenate(packed)),
                                   np.cumsum([0] + [p.shape[0] for p in packed]).tolist(),
                                   dev(np.stack(starts))),
    }
    return out, streams, parts(8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22, help="log2 of the R-MAT's vertices")
    ap.add_argument("--no-streams", action="store_true", help="time the single shapes only")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.kernels.partition_score import build as score_build

    ident = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    text = SOURCE.read_text()
    jobs = {v: (f"score_{v}", edit(text, e)) for v, e in VARIANTS.items()}
    jobs["row_block"] = ("score_row_block", ROW_BLOCK_SOURCE)
    jobs["floor"] = ("score_floor", FLOOR_SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per variant, all together
        paths = dict(zip(jobs, pool.map(lambda job: build(*job), jobs.values())))
    sigs = score_build.LIBRARY.signatures
    libs = {v: load(p, sigs) for v, p in paths.items() if v in VARIANTS}
    libs["row_block"] = load(paths["row_block"], {f: sigs[f] for f in (
        "partition_score_gather", "partition_score_sharded_gather")})
    floor = load(paths["floor"], FLOOR_SIGNATURES)
    print(json.dumps({"built_seconds": time.perf_counter() - t0, "variants": list(jobs)}), flush=True)

    t0 = time.perf_counter()
    graph = rmat_graph(1 << args.scale, avg_degree=16, seed=0)
    dgraph = graph.to("cuda")
    cases, streams, stream_parts = shapes(np, torch, graph, dgraph)
    print(json.dumps({"graph": f"rmat 2^{args.scale} avg_degree 16",
                      "setup_seconds": time.perf_counter() - t0}), flush=True)
    ip, ix = dgraph.indptr.data_ptr(), dgraph.indices.data_ptr()

    def launcher(lib, b, start, k, part_of, out, sizes):
        if start is None:
            def call():
                err = lib.partition_score_gather(ip, ix, part_of.data_ptr(), b.data_ptr(),
                                                 b.shape[0], sizes.data_ptr(), k, 0.0, 0.5,
                                                 out.data_ptr(),
                                                 torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
        else:
            def call():
                err = lib.partition_score_sharded_gather(
                    ip, ix, part_of.data_ptr(), b.data_ptr(), start.data_ptr(),
                    start.shape[0] - 1, b.shape[0], sizes.data_ptr(), k, 0.0, 0.5,
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
        return call

    def row(**fields):
        print(json.dumps({"ablation": "partition_score", **fields, "device": ident}), flush=True)

    for name, b, start, k, part_of in cases:
        c = b.shape[0]
        sizes = torch.zeros((1 if start is None else start.shape[0] - 1, k), device="cuda")
        out = torch.empty((c, k), device="cuda")
        want = None
        for v, lib in {**libs, "floor": None}.items():
            if v == "floor":
                call = floor_call(torch, floor, launch_shape(c, k))
            elif v == "count_ballot" and k > 32:
                continue  # a lane a partition: k <= 32 only
            else:
                call = launcher(lib, b, start, k, part_of, out, sizes)
            try:
                ms = graph_ms(torch, call)
            except RuntimeError as e:
                row(variant=v, shape=name, error=str(e))
                continue
            same = None
            if v != "floor":
                call()
                torch.cuda.synchronize()
                if want is None:
                    want = out.clone()
                same = bool(torch.equal(out, want))
            row(variant=v, shape=name, kernel=v == KERNEL, rows=c, k=k, ms=ms,
                same_as_kernel=same)
    if args.no_streams:
        return 0
    for name, (batch, bounds, starts) in streams.items():
        k = 8
        sizes = torch.zeros((1 if starts is None else 4, k), device="cuda")
        for v in (KERNEL, "row_block", "cluster8", "threads1024", "no_snap", "floor"):
            calls = []
            for i in range(len(bounds) - 1 if starts is not None else len(bounds)):
                lo, hi = (bounds[i], bounds[i + 1]) if starts is not None else bounds[i]
                b = batch[lo:hi]
                if v == "floor":
                    f = floor_call(torch, floor, launch_shape(hi - lo, k))
                    calls.append(lambda f=f: f())
                    continue
                st = None if starts is None else starts[i]

                def call(b=b, st=st, lib=libs[v]):
                    out = torch.empty((b.shape[0], k), device="cuda")
                    launcher(lib, b, st, k, stream_parts, out, sizes)()
                    return out
                calls.append(call)
            try:
                times, _ = stream_times(torch, calls)
            except RuntimeError as e:
                row(variant=v, shape=name, error=str(e))
                continue
            row(variant=v, shape=name, kernel=v == KERNEL, launches=len(calls), **times)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
