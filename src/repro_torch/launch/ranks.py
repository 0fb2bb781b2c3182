"""Starting and joining the ranks of a mesh run (the launchers' shared part).

A launcher given a mesh of more than one rank either runs as one rank of a
process group that already exists (the caller's, or ``torchrun``'s: ``RANK``
and ``WORLD_SIZE`` in the environment) or starts its own ranks: one spawned
process each, joined through a file store in a temporary directory. Rank
``p`` computes on ``analytics.engine.rank_devices``' device (``cuda:p %
count``, or the CPU). The backend is NCCL when every rank has a card of its
own and gloo when ranks share one (NCCL refuses two ranks on a card) or run
on the CPU.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import torch

from repro_torch.analytics.engine import check_backend, rank_devices
from repro_torch.device import resolve_device

__all__ = ["join", "rank_device", "run_in_group", "spawn"]


def rank_device(device: str, rank: int, world: int) -> torch.device:
    """The device rank ``rank`` of ``world`` computes on."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device(rank_devices(world, "cuda", torch.cuda.device_count())[rank])


def join(rank: int, world: int, device: str, init_method: str) -> None:
    """Join the default process group as ``rank`` of ``world`` (its card
    made current)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    devices = rank_devices(world, dev.type, torch.cuda.device_count() if dev.type == "cuda" else 0)
    backend = "nccl" if dev.type == "cuda" and len(set(devices)) == world else "gloo"
    check_backend(backend, devices)
    if dev.type == "cuda":
        torch.cuda.set_device(torch.device(devices[rank]))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)


def run_in_group(target, argv: list, device: str, n: int) -> dict:
    """``target(argv, out)`` in this process as one rank of ``n``: in the
    process group that exists, or in ``torchrun``'s (joined here, left
    after). ``out`` is the dict ``target`` fills."""
    import torch.distributed as dist

    out: dict = {}
    if dist.is_initialized():
        target(argv, out)
        return out
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            raise ValueError(f"the mesh needs {n} ranks, torchrun started {world}")
        join(int(os.environ["RANK"]), world, device, "env://")
        try:
            target(argv, out)
        finally:
            dist.destroy_process_group()
        return out
    return spawn(target, n, argv, device)


def spawn(target, n: int, argv: list, device: str) -> dict:
    """Run ``target(argv, out)`` in ``n`` spawned ranks and return rank 0's
    ``out`` (JSON-able); if a rank failed, ``out["error"]`` holds the
    message (rank 0's own where it raised) and ``out`` what rank 0 had
    filled before. ``target`` is a module-level function."""
    import torch.multiprocessing as mp

    resolve_device(device)  # raise here, before starting ranks, without a card
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        path = Path(tmp) / "rank0.json"
        error = None
        try:
            mp.start_processes(_entry, args=(n, (Path(tmp) / "store").as_uri(), target, argv,
                                             device, str(path)),
                               nprocs=n, join=True, start_method="spawn")
        except mp.ProcessRaisedException as err:
            error = str(err)
        out = json.loads(path.read_text()) if path.exists() else {}
    if error is not None:
        out.setdefault("error", error)
    return out


def _entry(rank: int, world: int, store: str, target, argv: list, device: str,
           path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    join(rank, world, device, store)
    out: dict = {}
    try:
        target(argv, out)
    except Exception as err:
        out["error"] = str(err)
        raise
    finally:
        if rank == 0:
            Path(path).write_text(json.dumps(out))
        dist.destroy_process_group()
