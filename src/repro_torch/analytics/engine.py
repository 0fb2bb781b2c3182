"""Partition-aware vertex-program engine (port of ``repro.analytics.engine``).

Two execution modes share one per-device step (:func:`local_step`):

  * ``simulated`` (:meth:`GraphEngine.run_simulated`): the K devices of a
    partition live on the leading axis of every array on one real device
    (the card, or the CPU when asked); the halo all-to-all is one index
    gather (``state[p, send_gather[p, q]]``) and a transpose.
  * ``sharded`` (:meth:`GraphEngine.run_sharded`, the reference's
    ``shard_map`` mode): one process per partition, the halo exchanged by
    ``torch.distributed.all_to_all_single``. :func:`run_rank` is the body
    of one rank under an existing process group (the SPMD form, usable
    under ``torchrun``); :func:`run_sharded` starts the ``k`` ranks itself.

The step on a device holding ``state`` f32[d, v_max] and the ghosts ``recv``
f32[d, k*h_max] (d = k simulated, d = 1 on a rank) is:

  * ``full = [state, recv, identity]``;
  * ``x = message(full, degrees_full)``, elementwise over the whole vector
    (the same bits as ``message(full[cols], degrees_full[cols])``);
  * one launch of the gather/reduce kernel over the devices' CSR rows
    (:func:`repro_torch.kernels.ell_spmv.ops.ell_spmv_segments`);
  * ``apply``.

A device's rows never depend on another device's in the kernel or its plain
version, so both modes give the same values bit for bit.

Every iteration stays on the device; the simulated mode copies only the
initial state in and the final values out (:func:`_gather_global`).
The engine's communication volume is exactly the paper's λ_CV·K·|V| when
counting true (unpadded) messages.

The reference's ``lower_sharded`` lowers the ``shard_map`` program to XLA
HLO for inspection; there is no HLO here. What stands in is the exchange
report of a sharded run (:attr:`GraphEngine.exchange`): the
``all_to_all_single`` calls of every rank, the elements every rank sends an
iteration (their sum is ``stats().padded_halo_elements_per_iter``), the
bytes staged through host memory, the exchange route and each rank's
kernel launches and milliseconds an iteration.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.analytics.localize import DeviceLocalized, LocalizedGraph
from repro_torch.analytics.programs import VertexProgram
from repro_torch.device import resolve_device
from repro_torch.kernels.ell_spmv import ops as spmv
from repro_torch.kernels.ell_spmv.ops import ell_spmv_segments

__all__ = ["BACKENDS", "GraphEngine", "RankLayout", "RunStats", "check_backend", "local_step",
           "rank_devices", "run_rank", "run_sharded"]

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass
class RunStats:
    iterations: int
    true_halo_messages_per_iter: int
    padded_halo_elements_per_iter: int
    bytes_per_iter_true: int
    bytes_per_iter_padded: int
    max_local_edges: int
    mean_local_edges: float


def local_step(program: VertexProgram, ctx: dict, state: torch.Tensor, recv: torch.Tensor,
               dev: DeviceLocalized, identity: torch.Tensor) -> torch.Tensor:
    """One iteration on ``d`` devices: ``state`` f32[d, v_max], ``recv``
    f32[d, k*h_max] (slot ``q*h_max + j`` holds the j-th ghost from ``q``),
    ``identity`` f32[d, 1]; ``dev`` holds the devices' ``cols``, ``row_ptr``
    and ``degrees_full``."""
    full = torch.cat([state, recv, identity], dim=1)
    msgs = program.message(full, dev.degrees_full)
    agg = ell_spmv_segments(msgs, dev.row_ptr, dev.cols, program.reduce_kind)
    return program.apply(state, agg, ctx)


class GraphEngine:
    """Runs ``program`` on the layout ``lg`` on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``)."""

    def __init__(self, lg: LocalizedGraph, program: VertexProgram, ctx: dict | None = None,
                 device: str | torch.device | None = None):
        self.lg = lg
        self.program = program
        self.ctx = dict(ctx or {})
        self.ctx.setdefault("num_vertices", lg.num_vertices)
        self.device = resolve_device(device)
        self.exchange: dict | None = None  # the last sharded run's report

    # ------------------------------------------------------------ simulated
    def run_simulated(self, iters: int) -> np.ndarray:
        """float32[|V|]: every vertex's state after ``iters`` iterations."""
        k = self.lg.k
        dev = self.lg.to(self.device)
        state = torch.from_numpy(self.program.init_state(self.lg, self.ctx)).to(self.device)
        devices = torch.arange(k, device=self.device)[:, None, None]
        identity = torch.full((k, 1), self.program.identity, dtype=torch.float32,
                              device=self.device)
        for _ in range(iters):
            send = state[devices, dev.send_gather]  # [k, k, h]: p ships send[p, q] to q
            recv = send.transpose(0, 1).reshape(k, -1)  # all-to-all: recv[p, q*h + j]
            state = local_step(self.program, self.ctx, state, recv, dev, identity)
        return _gather_global(self.lg, state.cpu().numpy())

    # -------------------------------------------------------------- sharded
    def run_sharded(self, iters: int, backend: str | None = None) -> np.ndarray:
        """float32[|V|] after ``iters`` iterations run by ``k`` processes,
        one per partition (rank ``p`` on ``cuda:(p % device_count)``, or on
        the CPU), the halo exchanged by ``all_to_all_single``. ``backend``
        defaults to ``"nccl"`` on the card and ``"gloo"`` on the CPU. The
        exchange report goes to :attr:`exchange`."""
        (values,), self.exchange = run_sharded(self.lg, [(self.program, self.ctx, iters)],
                                               self.device, backend)
        return values

    # -------------------------------------------------------------- helpers
    def stats(self, iters: int, bytes_per_elem: int = 4) -> RunStats:
        lg = self.lg
        true_m = lg.true_halo_messages()
        padded = lg.padded_halo_elements_per_iter()
        edges_per_dev = (lg.rows != lg.v_max).sum(axis=1)
        return RunStats(
            iterations=iters,
            true_halo_messages_per_iter=true_m,
            padded_halo_elements_per_iter=padded,
            bytes_per_iter_true=true_m * bytes_per_elem,
            bytes_per_iter_padded=padded * bytes_per_elem,
            max_local_edges=int(edges_per_dev.max()),
            mean_local_edges=float(edges_per_dev.mean()),
        )


def _gather_global(lg: LocalizedGraph, state_kv: np.ndarray) -> np.ndarray:
    out = np.zeros(lg.num_vertices, dtype=state_kv.dtype)
    for p in range(lg.k):
        c = int(lg.local_count[p])
        out[lg.local_to_global[p, :c]] = state_kv[p, :c]
    return out


# ------------------------------------------------------------------ one rank
@dataclasses.dataclass
class RankLayout:
    """What rank ``rank`` of ``k`` holds of a :class:`LocalizedGraph`."""

    rank: int
    k: int
    v_max: int
    h_max: int
    cols: np.ndarray  # int32[e_max]
    row_ptr: np.ndarray  # int64[v_max + 1]
    degrees_full: np.ndarray  # float32[v_max + k*h_max + 1]
    send_gather: np.ndarray  # int32[k, h_max]: what this rank ships to each q

    ARRAYS = ("cols", "row_ptr", "degrees_full", "send_gather")

    @classmethod
    def from_localized(cls, lg: LocalizedGraph, rank: int,
                       row_ptr: np.ndarray | None = None) -> RankLayout:
        """Rank ``rank``'s slices (``row_ptr``: ``lg.row_ptr()``, when the
        caller already has it)."""
        row_ptr = lg.row_ptr() if row_ptr is None else row_ptr
        return cls(rank=rank, k=lg.k, v_max=lg.v_max, h_max=lg.h_max, cols=lg.cols[rank],
                   row_ptr=row_ptr[rank], degrees_full=lg.degrees_full[rank],
                   send_gather=lg.send_gather[rank])

    def to(self, device: torch.device) -> DeviceLocalized:
        """The step's arrays on ``device``: a leading device axis of 1, and
        ``send_gather`` as int64[k, h_max] (this rank's rows of what it
        ships)."""
        return DeviceLocalized(
            cols=torch.from_numpy(np.ascontiguousarray(self.cols, np.int32)[None]).to(device),
            row_ptr=torch.from_numpy(np.ascontiguousarray(self.row_ptr, np.int64)[None]).to(device),
            degrees_full=torch.from_numpy(
                np.ascontiguousarray(self.degrees_full, np.float32)[None]).to(device),
            send_gather=torch.from_numpy(self.send_gather.astype(np.int64)).to(device),
        )


class _Exchange:
    """The halo all-to-all of one rank: ``send`` f32[k, h_max] on the rank's
    device in, ``recv`` f32[1, k*h_max] out (``recv[q*h_max + j]`` is what
    rank ``q`` shipped). NCCL moves device tensors; gloo with device state
    goes through two pinned host buffers, one copy each way a call."""

    def __init__(self, k: int, h_max: int, device: torch.device, backend: str, group):
        self.device, self.group = device, group
        self.staged = backend == "gloo" and device.type == "cuda"
        self.route = {"nccl": "nccl_device"}.get(
            backend, "gloo_pinned_host" if self.staged else "gloo_host")
        self.calls = 0
        self.staged_bytes = 0
        n = k * h_max
        if self.staged:
            self.send_host = torch.empty(n, dtype=torch.float32, pin_memory=True)
            self.recv_host = torch.empty(n, dtype=torch.float32, pin_memory=True)

    def __call__(self, send: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        self.calls += 1
        if self.staged:
            self.send_host.copy_(send.reshape(-1))  # waits for the state it reads
            dist.all_to_all_single(self.recv_host, self.send_host, group=self.group)
            self.staged_bytes += 2 * self.send_host.numel() * 4
            return self.recv_host.to(self.device)[None]
        send = send.reshape(-1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv[None]


def run_rank(layout: RankLayout, program: VertexProgram, ctx: dict, iters: int,
             state: np.ndarray, device: str | torch.device | None = None,
             group=None) -> tuple[np.ndarray, dict]:
    """Rank ``layout.rank``'s part of a sharded run under an initialised
    process group of ``layout.k`` ranks: ``iters`` iterations from
    ``state`` f32[v_max]. Returns the rank's final state and its counters
    (``all_to_all_calls``, ``elements_sent_per_iter``, ``staged_bytes``,
    ``spmv_launches``, ``iter_ms``, ``route``). Raises unless the group's
    size is ``k`` and this process is rank ``layout.rank`` in it."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if world != layout.k:
        raise ValueError(f"process group of {world} ranks != k={layout.k} partitions")
    if rank != layout.rank:
        raise ValueError(f"this process is rank {rank}, the layout is rank {layout.rank}'s")
    device = resolve_device(device)
    dev = layout.to(device)
    exchange = _Exchange(layout.k, layout.h_max, device, dist.get_backend(group), group)
    x = torch.from_numpy(np.array(state, np.float32)[None]).to(device)
    identity = torch.full((1, 1), program.identity, dtype=torch.float32, device=device)
    launches = spmv.launches
    dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(iters):
        recv = exchange(x[0][dev.send_gather])  # [k, h_max] out, [1, k*h_max] in
        x = local_step(program, ctx, x, recv, dev, identity)
    out = x[0].cpu().numpy()  # waits for the last iteration
    seconds = time.perf_counter() - t0
    return out, {
        "rank": layout.rank, "device": str(device), "route": exchange.route,
        "all_to_all_calls": exchange.calls, "elements_sent_per_iter": layout.k * layout.h_max,
        "staged_bytes": exchange.staged_bytes, "spmv_launches": spmv.launches - launches,
        "iter_ms": 1e3 * seconds / max(iters, 1),
    }


# ------------------------------------------------------------------ k ranks
def rank_devices(k: int, device_type: str, device_count: int) -> list[str]:
    """Rank ``p``'s device: ``cuda:(p % device_count)`` on the card, else
    the CPU."""
    if device_type == "cuda":
        if device_count < 1:
            raise RuntimeError("no CUDA device is available")
        return [f"cuda:{p % device_count}" for p in range(k)]
    return ["cpu"] * k


def check_backend(backend: str, devices: list[str]) -> None:
    """Raise unless ``backend`` can join ranks placed on ``devices``: gloo
    takes any placement, NCCL only CUDA ranks on cards of their own."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return
    if any(not d.startswith("cuda") for d in devices):
        raise ValueError('backend="nccl" needs CUDA ranks; use backend="gloo" on the CPU')
    if len(set(devices)) < len(devices):
        raise ValueError(
            f'backend="nccl" takes one rank a card, but {len(devices)} ranks would share '
            f"{len(set(devices))} card(s); pass backend=\"gloo\" to run them on shared cards")


def run_sharded(lg: LocalizedGraph, runs: list, device: str | torch.device | None = None,
                backend: str | None = None) -> tuple[list[np.ndarray], dict]:
    """Run every ``(program, ctx, iters)`` of ``runs`` in one start of ``k``
    processes, one a partition (rank ``p`` on ``rank_devices``), and return
    each run's float32[|V|] values and the exchange report. The arrays go to
    the ranks as ``.npy`` files in a temporary directory, which also holds
    the rendezvous file store; programs must pickle (``PROGRAMS``' do).
    The ranks are spawned, so a script that calls this needs the ``if
    __name__ == "__main__":`` guard."""
    import torch.multiprocessing as mp

    if not runs:
        raise ValueError("run_sharded needs at least one (program, ctx, iters) run")
    device = resolve_device(device)
    k = lg.k
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    devices = rank_devices(k, device.type, count)
    check_backend(backend, devices)
    jobs = []
    for program, ctx, iters in runs:
        ctx = dict(ctx or {})
        ctx.setdefault("num_vertices", lg.num_vertices)
        try:
            pickle.dumps((program, ctx))
        except Exception as err:
            raise ValueError(f"program {program.name!r} and its ctx must pickle to reach the "
                             f"ranks (build it from module-level functions): {err}") from err
        jobs.append((program, ctx, int(iters)))
    with tempfile.TemporaryDirectory(prefix="repro_sharded_") as tmp:
        work = Path(tmp)
        row_ptr = lg.row_ptr()
        for p in range(k):
            layout = RankLayout.from_localized(lg, p, row_ptr)
            for name in RankLayout.ARRAYS:
                np.save(work / f"r{p}_{name}.npy", getattr(layout, name))
        for j, (program, ctx, _) in enumerate(jobs):
            np.save(work / f"init{j}.npy", program.init_state(lg, ctx))
        t0 = time.perf_counter()
        started = time.time()
        mp.start_processes(_rank_main, args=(k, lg.v_max, lg.h_max, str(work), backend, devices,
                                             jobs, started), nprocs=k, join=True,
                           start_method="spawn")
        spawn_seconds = time.perf_counter() - t0
        ranks = [json.loads((work / f"rank{p}.json").read_text()) for p in range(k)]
        values = [_gather_global(lg, np.stack([np.load(work / f"out{j}_{p}.npy")
                                               for p in range(k)]))
                  for j in range(len(jobs))]
    report = {
        "backend": backend, "k": k, "devices": devices, "route": ranks[0]["runs"][0]["route"],
        "spawn_seconds": spawn_seconds,
        # each rank's wall-clock seconds from the start to: its first line,
        # the group joined, its arrays loaded, its runs done
        "rank_timeline": [r["timeline"] for r in ranks],
        "runs": [{
            "program": program.name, "iters": iters,
            "all_to_all_calls": [r["runs"][j]["all_to_all_calls"] for r in ranks],
            "elements_sent_per_iter": sum(r["runs"][j]["elements_sent_per_iter"] for r in ranks),
            "staged_bytes": [r["runs"][j]["staged_bytes"] for r in ranks],
            "spmv_launches": [r["runs"][j]["spmv_launches"] for r in ranks],
            "iter_ms": [r["runs"][j]["iter_ms"] for r in ranks],
        } for j, (program, _, iters) in enumerate(jobs)],
    }
    return values, report


def _rank_main(rank: int, k: int, v_max: int, h_max: int, work: str, backend: str,
               devices: list[str], jobs: list, started: float) -> None:
    """A spawned rank: join the group through the file store, load this
    rank's arrays, run every job, write the states and counters back."""
    import torch.distributed as dist

    timeline = {"entered": time.time() - started}
    work = Path(work)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // k))  # k ranks share the host
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=(work / "store").as_uri(), rank=rank,
                            world_size=k)
    timeline["joined"] = time.time() - started
    try:
        arrays = {name: np.load(work / f"r{rank}_{name}.npy") for name in RankLayout.ARRAYS}
        layout = RankLayout(rank=rank, k=k, v_max=v_max, h_max=h_max, **arrays)
        timeline["loaded"] = time.time() - started
        runs = []
        for j, (program, ctx, iters) in enumerate(jobs):
            state = np.load(work / f"init{j}.npy", mmap_mode="r")[rank]
            out, counters = run_rank(layout, program, ctx, iters, state, device)
            np.save(work / f"out{j}_{rank}.npy", out)
            runs.append(counters)
        timeline["ran"] = time.time() - started
        tmp = work / f"rank{rank}.json.tmp"
        tmp.write_text(json.dumps({"rank": rank, "runs": runs, "timeline": timeline}))
        os.replace(tmp, work / f"rank{rank}.json")
    finally:
        dist.destroy_process_group()
