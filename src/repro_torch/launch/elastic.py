"""Crash-and-resume demo (port of ``repro.launch.elastic``): train, crash
at half the steps, resume from the host checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.elastic --ckpt-dir /tmp/elastic
    PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu --steps 20 \\
        --arch reduced:qwen3-8b

Checkpoints hold host arrays, so a restart may change the mesh. As in the
reference, phase 2 resumes on a ``1x2`` mesh when two ranks can be had
(two cards, or two ranks sharing one card or the CPU over gloo) and on
``1x1`` otherwise; ``--resume-mesh`` names another.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch import train as train_mod


def two_ranks(device: str) -> bool:
    """Whether a two-rank mesh can run here: the launcher can start two ranks
    (on two cards, or sharing one card or the CPU over gloo) unless this
    process already belongs to a process group of another size."""
    import torch.distributed as dist

    resolve_device(device)
    if not dist.is_available():
        return False
    return not dist.is_initialized() or dist.get_world_size() == 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits with an error without a card) or cpu")
    ap.add_argument("--resume-mesh", default=None,
                    help="phase 2's mesh (default 1x2 when two ranks can be had, else 1x1)")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="elastic_")
    common = ["--arch", args.arch, "--steps", str(args.steps), "--global-batch", "8",
              "--seq-len", "128", "--ckpt-dir", ckpt, "--ckpt-every", "10",
              "--device", args.device]

    half = args.steps // 2
    print(f"[elastic] phase 1: mesh 1x1 for {half} steps")
    try:
        train_mod.main([*common, "--mesh", "1x1", "--fail-at", str(half)])
    except RuntimeError as e:
        print(f"[elastic] caught: {e}")

    mesh2 = args.resume_mesh or ("1x2" if two_ranks(args.device) else "1x1")
    print(f"[elastic] phase 2: resume on mesh {mesh2} (survivors)")
    loss = train_mod.main([*common, "--mesh", mesh2])
    print(f"[elastic] recovered and finished; final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
