#!/usr/bin/env python3
"""Where a memory-mapped ``fennel`` stream spends its time on the card.

    python3 scripts/outofcore_decode_study.py            # one CUDA card, 2^22 R-MAT
    python3 scripts/outofcore_decode_study.py --tiny     # CPU rehearsal at 2^12

Writes ``chip_smoke.py`` phase 2's graph (R-MAT, 2^scale vertices, average
degree 16, seed 0) as v2 and v1 files, then runs phase 2's spec (``fennel``,
k=8, edge balance, random order, seed 0) in one child process per case, so
that each case's peak RSS (:class:`PeakRss`) and peak device memory are its
own:

* ``resident``: the v1 file read into a resident ``CSRGraph`` (``to_csr``);
* ``v2``/``v1`` with ``prefetch`` ``"auto"`` (decode-ahead on a thread) and
  ``"off"`` (the fetch inline, on the placement thread);
* ``fetch_only``: the v2 stream's fetch (decode, expansion, packing) for
  every chunk on one thread with no placement, the engine's
  ``_iter_chunk_expansions`` as the rows route runs it.

Every case must give the resident assignment. One JSON line a case, then
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class PeakRss:
    """This process's peak resident set in bytes, from the time it is made:
    the largest of ``/proc/self/statm``'s resident pages, sampled every
    ``interval`` seconds on a daemon thread, and ``VmHWM`` where the kernel
    reports it; None where neither can be read. (``ru_maxrss`` survives
    ``exec``: a child would report its parent's peak.)"""

    def __init__(self, interval: float = 0.02):
        self.interval = interval
        self.peak = self.current()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def current() -> int:
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            return 0

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, self.current())

    def read(self) -> int | None:
        """The peak so far (the sampler keeps running)."""
        hwm = 0
        try:
            for line in Path("/proc/self/status").read_text().splitlines():
                if line.startswith("VmHWM:"):
                    hwm = int(line.split()[1]) * 1024
        except OSError:
            pass
        return max(self.peak, self.current(), hwm) or None

    def stop(self) -> int | None:
        self._stop.set()
        self._thread.join()
        return self.read()


def child(case: str, path: str, out: str, tiny: bool) -> int:
    rss = PeakRss()
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.api as tapi
    from repro_torch.core import engine
    from repro_torch.core.base import PartitionState
    from repro_torch.graph.external import ExternalCSRGraph
    from repro_torch.kernels.partition_score import ops

    device = torch.device("cpu" if tiny else "cuda")
    if device.type == "cuda":
        ops.build.LIBRARY.load()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rss_base = rss.current()  # the interpreter, torch and the CUDA runtime
    graph = ExternalCSRGraph(path)
    if case == "resident":
        graph = graph.to_csr()
    spec = tapi.PartitionSpec(algo="fennel", k=8, epsilon=0.05, balance_mode="edge",
                              order="random", seed=0,
                              params={"prefetch": "off" if case.endswith("off") else "auto"})
    row = {"case": case}
    if case == "fetch_only":
        state = PartitionState.create(graph, 8, 0.05, "edge", seed=0, device=device)
        eng = engine.StreamEngine(graph, state, engine.FennelScorer(graph, 8), None,
                                  order="random", seed=0,
                                  config=engine.EngineConfig(prefetch="off"))
        t0 = time.perf_counter()
        nnz = sum(int(x[3][1].shape[0]) for x in engine._iter_chunk_expansions(eng, pack=True))
        row.update(fetch_seconds=time.perf_counter() - t0, entries=nnz,
                   decode_wall_s=graph.decode_wall_s)
    else:
        ops.reset()
        res = tapi.partition(graph, spec, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        tel = res.telemetry
        np.save(out, res.assignment)
        row.update(
            stream_seconds=res.timings["stream_seconds"], kernel_calls=tel["kernel_calls"],
            launches={"gather": ops.launches, "rows": ops.rows_launches},
            **{k: tel.get(k) for k in ("decode_wall_s", "prefetch_hit_rate", "prefetch_wait_s",
                                       "graph_backing", "peak_graph_bytes")},
        )
    row.update(peak_rss_bytes=rss.stop(), rss_before_graph_bytes=rss_base, max_memory_allocated=(
        torch.cuda.max_memory_allocated() if device.type == "cuda" else None))
    print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true", help="rehearse on the CPU at 2^12")
    ap.add_argument("--child", nargs=3, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(*args.child, tiny=args.tiny)

    import numpy as np
    import torch

    if not args.tiny and not torch.cuda.is_available():
        print("outofcore_decode_study: no CUDA device (--tiny rehearses on the CPU)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.graph.external import convert_csr
    from repro_torch.graph.generators import rmat_graph

    scale = 12 if args.tiny else 22
    t0 = time.perf_counter()
    graph = rmat_graph(1 << scale, avg_degree=16, seed=0)
    print(json.dumps({"graph": f"rmat 2^{scale} avg_degree 16", "generate_seconds":
                      time.perf_counter() - t0, "graph_bytes":
                      graph.indptr.nbytes + graph.indices.nbytes}), flush=True)
    with tempfile.TemporaryDirectory(prefix="ooc_study") as td:
        files = {}
        for v in (2, 1):
            files[v] = str(Path(td) / f"g{v}.bin")
            t0 = time.perf_counter()
            convert_csr(graph, files[v], format_version=v)
            print(json.dumps({"format_version": v, "write_seconds": time.perf_counter() - t0,
                              "file_bytes": Path(files[v]).stat().st_size}), flush=True)
        del graph
        want = None
        for case, v in (("resident", 1), ("v2_auto", 2), ("v2_off", 2), ("v1_auto", 1),
                        ("v1_off", 1), ("fetch_only", 2)):
            out = str(Path(td) / f"{case}.npy")
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child", case, files[v], out]
                + (["--tiny"] if args.tiny else []),
                capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                raise SystemExit(f"{case} failed:\n{proc.stdout}\n{proc.stderr}")
            print(proc.stdout.strip().splitlines()[-1], flush=True)
            if case == "fetch_only":
                continue
            got = np.load(out)
            if want is None:
                want = got
            elif not np.array_equal(got, want):
                raise SystemExit(f"{case}: assignment differs from the resident run's")
    if not args.tiny:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
