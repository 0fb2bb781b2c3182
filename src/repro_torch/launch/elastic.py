"""Crash-and-resume demo (port of ``repro.launch.elastic``): train, crash
at half the steps, resume from the host checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.elastic --ckpt-dir /tmp/elastic
    PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu --steps 20 \\
        --arch reduced:qwen3-8b

Checkpoints hold host arrays, so a restart may change the device count.
The reference resumes on a ``1x2`` mesh when it finds two devices and on
``1x1`` with one; the port trains on one device, so phase 2 resumes on
``1x1`` (a re-mesh waits for ROADMAP Queue 1 item 8d).
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits with an error without a card) or cpu")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="elastic_")
    common = ["--arch", args.arch, "--steps", str(args.steps), "--global-batch", "8",
              "--seq-len", "128", "--mesh", "1x1", "--ckpt-dir", ckpt, "--ckpt-every", "10",
              "--device", args.device]

    half = args.steps // 2
    print(f"[elastic] phase 1: mesh 1x1 for {half} steps")
    try:
        train_mod.main([*common, "--fail-at", str(half)])
    except RuntimeError as e:
        print(f"[elastic] caught: {e}")

    print("[elastic] phase 2: resume on mesh 1x1 (survivors)")
    loss = train_mod.main(common)
    print(f"[elastic] recovered and finished; final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
