"""End-to-end driver on the PyTorch port: train the ~100M-param model for a
few hundred steps with checkpointing (on a CUDA card; ``--device cpu`` runs
the plain versions, slowly).

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train_main([
        "--arch", "repro-100m",
        "--steps", str(args.steps),
        "--global-batch", "16",
        "--seq-len", "256",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--log-every", "20",
        "--device", args.device,
    ])
