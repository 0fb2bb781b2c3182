#!/usr/bin/env python3
"""Where the gather/reduce and the selective-scan kernels spend their time,
on one CUDA card.

Builds ``src/repro_torch/kernels/ell_spmv/csrc/ell_spmv.cu`` and
``src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu`` as they are, with
one tiling constant changed, and with part of the work cut out.

The spmv part times the analytics engine's launch (``ell_spmv_segments``,
sum and min) on the layout ``chip_smoke.py`` phase 9 times: ``fennel`` at
k=8 on an R-MAT of 2^22 vertices (``--scale``), average degree 16, seed 0:

    items<n>    tiles of 256 x n path items (rows + entries); the kernel's
                own value is marked "kernel"
    probes32    32 lanes probing row_ptr in each round of a tile's search,
                not 8
    loads_only  the tile searches, the staged gathers and the head rows'
                earlier entries; no walk and no row written
    no_combine  all but the joining of rows that cross threads (the carries'
                scan); those rows are not written

beside ``x.gather`` + ``scatter_reduce_`` (the library call). The scan part
times one falcon-mamba-7b layer at prefill (B=1, T=8192, D=8192, N=16,
float32, the model's A = -(1..N)):

    states<s>   s states of a channel a thread (N / s warps a block)
    chunk32     32 time steps a buffer instead of 64
    ahead<k>    k values of B (and of C) a batch of the walk loads: k / s
                steps a batch (16 in the kernel)
    no_exp      the exponential's argument in place of the exponential
    no_loads    only the first chunk copied; the rest walk stale buffers
    loads_only  the chunks' copies, the barriers and the y stores; no
                recurrence

The cut versions compute garbage; only their times mean anything. Each row
is the mean of CUDA-event timings over back-to-back launches. Run from the
repository root on a machine with the card and the CUDA toolkit:

    python3 scripts/kernel_ablation_spmv_scan.py [--part spmv|scan|both] [--scale 22]
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
SPMV_SOURCE = ROOT / "src/repro_torch/kernels/ell_spmv/csrc/ell_spmv.cu"
SCAN_SOURCE = ROOT / "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
OUT = ROOT / "build" / "ablation"
HBM_BYTES_PER_S = 3.35e12

# exact lines of the sources (from the line break before) and what each
# variant puts in their place
SPMV_ITEMS = "\nconstexpr int kItemsPerThread = 8;"
SPMV_VARIANTS = {
    "items4": [(SPMV_ITEMS, "\nconstexpr int kItemsPerThread = 4;")],
    "items8": [],
    "items16": [(SPMV_ITEMS, "\nconstexpr int kItemsPerThread = 16;")],
    "probes32": [("\nconstexpr int kProbes = 8;", "\nconstexpr int kProbes = 32;")],
    # after the staging barrier: read the staged values once, so the loads
    # stay, and stop
    "loads_only": [("\n  pre[tid] = part;\n  __syncthreads();\n",
                    "\n  pre[tid] = part;\n  __syncthreads();\n"
                    "  if (vals[tid * 37 % kTile] == -1.0f && pre[tid] == init) row_out[0] = ends[tid];\n"
                    "  return;\n")],
    "no_combine": [("\n    row_out[first] = O::finish(O::join(total, first_val));\n", "\n")],
}
SCAN_STATES = "\nconstexpr int kStates = 4;"
SCAN_VARIANTS = {
    "states2": [(SCAN_STATES, "\nconstexpr int kStates = 2;")],
    "states4": [],
    "states8": [(SCAN_STATES, "\nconstexpr int kStates = 8;")],
    "states16": [(SCAN_STATES, "\nconstexpr int kStates = 16;")],
    "chunk32": [("\nconstexpr int kChunk = 64;", "\nconstexpr int kChunk = 32;")],
    "ahead32": [("\nconstexpr int kAhead = 16;", "\nconstexpr int kAhead = 32;")],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
    "no_loads": [("\n      stage<T, N, S>(x, dt, b, c, xs + (1 - buf) * K::kXElems,", "\n      if (0) stage<T, N, S>(x, dt, b, c, xs + (1 - buf) * K::kXElems,")],
    "loads_only": [("\n    walk_chunk<T, N, S, K::kSteps>(xc, dc, bc, cc, yp + buf * K::kYElems, a2, h, skip, steps,\n                                   lane, g);\n", "\n")],
}


def edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ablation: the source no longer has exactly one {old.strip()!r}")
        text = text.replace(old, new)
    return text


def build(name: str, text: str) -> Path:
    from repro_torch.kernels.nvcc import NVCC_FLAGS, _nvcc

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


def timed(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spmv_rows(torch, libs, scale: int, ident: str):
    import repro_torch.api as tapi
    from repro_torch.graph.generators import rmat_graph
    from repro_torch.kernels.ell_spmv import ops as spmv
    from repro_torch.kernels.ell_spmv.ref import segment_entries

    t0 = time.perf_counter()
    graph = rmat_graph(1 << scale, avg_degree=16, seed=0)
    spec = tapi.PartitionSpec(algo="fennel", k=8, epsilon=0.05, balance_mode="edge",
                              order="random", seed=0)
    lg = tapi.partition(graph, spec, device="cuda").localized()
    dev = lg.to("cuda")
    print(json.dumps({"layout": f"rmat 2^{scale} fennel k=8", "k": lg.k, "v_max": lg.v_max,
                      "e_max": lg.e_max, "state_len": lg.state_len,
                      "setup_seconds": time.perf_counter() - t0}), flush=True)
    k, v_max, state_len, e_max = lg.k, lg.v_max, lg.state_len, lg.e_max
    rows, pos = segment_entries(dev.row_ptr, e_max)
    nnz = int(rows.shape[0])
    x_read = int(torch.unique((pos // e_max) * state_len + dev.cols.reshape(-1)[pos]).shape[0])
    del rows, pos
    nbytes = k * (v_max + 1) * 8 + nnz * 4 + x_read * 4 + k * v_max * 4
    rows64 = torch.from_numpy(lg.rows.astype("int64")).to("cuda")
    cols64 = dev.cols.long()
    gen = torch.Generator(device="cuda").manual_seed(9)
    stream = torch.cuda.current_stream().cuda_stream
    for reduce, ident_value in (("sum", 0.0), ("min", 3e38)):
        x = torch.rand((k, state_len), generator=gen, device="cuda")
        x[:, -1] = ident_value
        out = torch.empty((k, v_max), dtype=torch.float32, device="cuda")
        times = {}
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.ell_spmv_segments(x.data_ptr(), dev.row_ptr.data_ptr(),
                                            dev.cols.data_ptr(), k, v_max, state_len, e_max,
                                            spmv.REDUCES[reduce], out.data_ptr(), stream)
                if err:
                    raise SystemExit(f"ablation: {name} launch failed: CUDA error {err}")
            times[name] = timed(torch, call)
        red = "sum" if reduce == "sum" else "amin"
        times["library"] = timed(torch, lambda: torch.full(
            (k, v_max + 1), ident_value, device="cuda").scatter_reduce_(
                1, rows64, x.gather(1, cols64), red, include_self=True))
        for name, ms in times.items():
            print(json.dumps({"ablation": "ell_spmv", "variant": name, "reduce": reduce,
                              "kernel": name == "items8", "ms": ms, "nnz": nnz,
                              "gb_per_s": nbytes / ms / 1e6,
                              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "device": ident}),
                  flush=True)


def scan_rows(torch, libs, ident: str):
    bsz, t, d, n = 1, 8192, 8192, 16
    gen = torch.Generator(device="cuda").manual_seed(d + t)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    x, dt = rnd(bsz, t, d), rnd(bsz, t, d).abs() * 0.1 + 0.01
    a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").expand(d, n).contiguous()
    b, c, d_skip = rnd(bsz, t, n), rnd(bsz, t, n), rnd(d)
    y, h = torch.empty_like(x), torch.empty((bsz, d, n), device="cuda")
    exp_ms = bsz * t * d * n / (132 * 16 * 1.98e9) * 1e3  # chip_smoke.py's EXP_PER_S
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        def call(lib=lib):
            err = lib.selective_scan_fwd(0, n, x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                                         b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
                                         y.data_ptr(), h.data_ptr(), bsz, t, d, stream)
            if err:
                raise SystemExit(f"ablation: {name} launch failed: CUDA error {err}")
        ms = timed(torch, call, reps=10)
        print(json.dumps({"ablation": "selective_scan", "variant": name,
                          "kernel": name == "states4", "ms": ms, "exp_bound_ms": exp_ms,
                          "exp_bound_share": exp_ms / ms, "shape": [bsz, t, d, n],
                          "device": ident}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("spmv", "scan", "both"), default="both")
    ap.add_argument("--scale", type=int, default=22, help="log2 of the R-MAT's vertices")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ell_spmv import build as spmv_build
    from repro_torch.kernels.mamba_scan import build as scan_build

    ident = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    if args.part in ("spmv", "both"):
        text = SPMV_SOURCE.read_text()
        jobs.update({("spmv", v): (f"spmv_{v}", edit(text, e)) for v, e in SPMV_VARIANTS.items()})
    if args.part in ("scan", "both"):
        text = SCAN_SOURCE.read_text()
        jobs.update({("scan", v): (f"scan_{v}", edit(text, e)) for v, e in SCAN_VARIANTS.items()})
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per variant, all together
        paths = dict(zip(jobs, pool.map(lambda job: build(*job), jobs.values())))
    if args.part in ("scan", "both"):
        libs = {v: load(p, scan_build.LIBRARY.signatures)
                for (part, v), p in paths.items() if part == "scan"}
        scan_rows(torch, libs, ident)
    if args.part in ("spmv", "both"):
        libs = {v: load(p, spmv_build.LIBRARY.signatures)
                for (part, v), p in paths.items() if part == "spmv"}
        spmv_rows(torch, libs, args.scale, ident)
    return 0


if __name__ == "__main__":
    sys.exit(main())
