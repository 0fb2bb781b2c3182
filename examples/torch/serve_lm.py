"""Serve a (reduced) model on the PyTorch port: real prefill + greedy decode
loop, with the attention (and, for Mamba layers, the scan) kernels.

    PYTHONPATH=src python examples/torch/serve_lm.py [--arch reduced:jamba-v0.1-52b] [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="reduced:qwen3-8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve_main(["--arch", args.arch, "--batch", "2", "--prompt-len", "16",
                "--gen", "8", "--device", args.device])
