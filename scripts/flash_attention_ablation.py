#!/usr/bin/env python3
"""Where the tensor-core attention kernel spends its time, on one CUDA card.

Builds ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
as it is and with parts of the bf16 prefill kernel's main loop taken out,
and times each at one qwen3-8b prefill layer (B=1, Hq=32, Hkv=8, T=8192,
Dh=128, bf16, causal) beside ``F.scaled_dot_product_attention``:

    full           the kernel
    no_products    the softmax, the loads and the barriers; no wgmma
    no_softmax     the products, the loads and the barriers; no softmax
    loads_only     the loads and the barriers alone

The cut versions compute garbage; only their times mean anything. Run from
the repository root on a machine with the card and the CUDA toolkit:

    python3 scripts/flash_attention_ablation.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
OUT = ROOT / "build" / "ablation"

# exact lines of the kernel's main loop (with their indentation, from the
# line break before), and what each cut puts in their place
QK = [("\n        issue_qk(stage);\n", "\n        wgmma_commit();\n"),
      ("\n          issue_qk(stage);\n", "\n          wgmma_commit();\n")]
PV = [("\n          issue_pv(prev);\n", "\n"),
      ("\n        issue_pv(prev);\n", "\n        wgmma_commit();\n")]
SOFTMAX = [("\n        softmax(wlo);\n", "\n"), ("\n          softmax(tile);\n", "\n")]
CUTS = {"full": [], "no_products": QK + PV, "no_softmax": SOFTMAX,
        "loads_only": QK + PV + SOFTMAX}


def cut(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ablation: the source no longer has exactly one {old.strip()!r}")
        text = text.replace(old, new)
    return text


def build(name: str, text: str) -> Path:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.nvcc import NVCC_FLAGS, _nvcc

    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"ablation: nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.flash_attention import ops as fa

    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(zip(CUTS, pool.map(lambda kv: build(kv[0], cut(text, kv[1])), CUTS.items())))
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    b, hq, hkv, t, dh = 1, 32, 8, 8192, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda").bfloat16().transpose(1, 2)
               for h in (hq, hkv, hkv))
    out = torch.empty((b, t, hq, dh), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    variant = fa.VARIANTS.index(fa.kernel_variant(q.dtype, t, hq // hkv, dh, True))
    flops = 4 * b * hq * dh * t * (t + 1) // 2

    def timed(fn, reps=20) -> float:
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

    rows = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.flash_attention_fwd.argtypes = fa_build.LIBRARY.signatures["flash_attention_fwd"]

        def call(lib=lib):
            err = lib.flash_attention_fwd(
                variant, 1, dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, hq, hkv, t, t, 1, 0, 0, dh**-0.5,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ablation: {name} launch failed: CUDA error {err}")

        rows[name] = timed(call)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    rows["sdpa"] = timed(lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                                enable_gqa=True))
    for name, ms in rows.items():
        print(json.dumps({"ablation": name, "ms": ms, "tflops": flops / ms / 1e9,
                          "shape": [b, hq, hkv, t, dh], "device": ident}), flush=True)
    print(ident)
    return 0


if __name__ == "__main__":
    sys.exit(main())
