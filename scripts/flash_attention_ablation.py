#!/usr/bin/env python3
"""Where the attention kernel spends its time, on one CUDA card.

Builds ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
as it is and with parts of a kernel's main loop (in the templates of
``flash_attention.cuh``, which the copy includes) taken out. The prefill
part times the tensor-core kernel at one qwen3-8b prefill layer (B=1,
Hq=32, Hkv=8, T=8192, Dh=128, bf16, causal):

    full           the kernel
    no_products    the softmax, the loads and the barriers; no wgmma
    no_softmax     the products, the loads and the barriers; no softmax
    loads_only     the loads and the barriers alone

The decode part times the split-KV decode kernel at one qwen3-8b layer of a
decode step over a 32k cache (Tq=1, Tk=32768, bf16) at B=32 and B=8, at
the split count the wrapper picks and at others (``n_split``), and cut:

    decode_full        the kernel and, with n_split > 1, the merge
    decode_loads_only  the ring's copies and barriers alone, at the same split

The latent part times MLA's absorbed decode on the tensor cores
(``latent_wgmma``, built by ``csrc/flash_attention_mla.cu``) at
deepseek-v2-236b's widths (128 query heads on one latent head, (Dqk, Dv) =
(576, 512), bf16) over a 32k latent cache at B=8 (at the split count the
wrapper picks and at others) and over the serve loop's 160 keys, cut:

    latent_full        the kernel and, with n_split > 1, the merge
    latent_one_qk      the second warpgroup takes no S of its own: the QK
                       product a tile once, as a block sharing S would
    latent_no_softmax  the products, the loads and the barriers
    latent_loads_only  the ring's TMA copies and barriers alone

beside the FMA kernel (``decode_latent``) on the same inputs.

Each part is timed beside ``F.scaled_dot_product_attention``. The cut
versions compute garbage; only their times mean anything. Run from the
repository root on a machine with the card and the CUDA toolkit:

    python3 scripts/flash_attention_ablation.py [--part prefill|decode|latent|both]
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
SOURCE = CSRC / "flash_attention.cu"
HEADER = CSRC / "flash_attention.cuh"  # the kernels' code: what the cuts edit
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
DECODE_CUTS = {"decode_loads_only": [("\n    consume(st, s_lo + j);\n", "\n")]}
DECODE_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 32)
# latent_wgmma's consumer loop
LAT_QK = ("\n      issue_qk(stage);\n", "\n      wgmma_commit();\n")
LAT_PV = ("\n      issue_pv(stage);\n", "\n      wgmma_commit();\n")
LAT_SOFTMAX = ("\n      softmax(tile);\n", "\n")
LATENT_CUTS = {
    "latent_full": [],
    "latent_one_qk": [(LAT_QK[0], "\n      if (wg == 0) {\n        issue_qk(stage);\n"
                                "      } else {\n        wgmma_commit();\n      }\n")],
    "latent_no_softmax": [LAT_SOFTMAX],
    "latent_loads_only": [LAT_QK, LAT_PV, LAT_SOFTMAX],
}
LATENT_SPLITS = (1, 2, 4, 8, 16, 32)


def cut(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"ablation: the source no longer has exactly one {old.strip()!r}")
        text = text.replace(old, new)
    return text


def build(name: str, header: str, source: Path = SOURCE) -> Path:
    """The library built from the source beside a copy of the header."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.nvcc import NVCC_FLAGS, _nvcc

    where = OUT / name
    where.mkdir(parents=True, exist_ok=True)
    (where / HEADER.name).write_text(header)
    src, lib = where / source.name, OUT / f"lib{name}.so"
    src.write_text(source.read_text())
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"ablation: nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def timed(torch, fn, reps=20) -> float:
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


def prefill_rows(torch, F, fa, fa_build, libs, ident):
    b, hq, hkv, t, dh = 1, 32, 8, 8192, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda").bfloat16().transpose(1, 2)
               for h in (hq, hkv, hkv))
    out = torch.empty((b, t, hq, dh), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    variant = fa.VARIANTS.index(fa.kernel_variant(q.dtype, t, hq // hkv, dh, True))
    flops = 4 * b * hq * dh * t * (t + 1) // 2

    rows = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.flash_attention_fwd.argtypes = fa_build.LIBRARY.signatures["flash_attention_fwd"]

        def call(lib=lib):
            err = lib.flash_attention_fwd(
                variant, 1, dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, hq, hkv, t, t, 1, 0, 0, dh**-0.5, None, 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ablation: {name} launch failed: CUDA error {err}")

        rows[name] = timed(torch, call)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    rows["sdpa"] = timed(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True))
    for name, ms in rows.items():
        print(json.dumps({"ablation": name, "ms": ms, "tflops": flops / ms / 1e9,
                          "shape": [b, hq, hkv, t, dh], "device": ident}), flush=True)


def decode_rows(torch, F, fa, fa_build, libs, ident):
    hq, hkv, tk, dh = 32, 8, 32768, 128
    device = torch.device("cuda", torch.cuda.current_device())
    sms = fa.sm_count(device)
    per_sm = fa.decode_blocks_per_sm(device, torch.bfloat16, dh, hq // hkv)
    variant = fa.VARIANTS.index("decode_split")
    for b in (32, 8):
        gen = torch.Generator(device="cuda").manual_seed(b)
        q = torch.randn(b, 1, hq, dh, generator=gen, device="cuda").bfloat16().transpose(1, 2)
        k, v = (torch.randn(b, tk, hkv, dh, generator=gen, device="cuda").bfloat16()
                .transpose(1, 2) for _ in range(2))
        out = torch.empty((b, 1, hq, dh), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
        strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
        nbytes = 2 * b * hkv * tk * dh * 2 + 2 * b * hq * dh * 2
        bound_ms = nbytes / 3.35e12 * 1e3
        chosen = fa.decode_splits(b, hkv, tk, sms, per_sm)

        def call(lib, n_split):
            ws = torch.empty(b * hq * n_split * (dh + 2), dtype=torch.float32, device="cuda")
            err = lib.flash_attention_fwd(
                variant, 1, dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, hq, hkv, 1, tk, 1, 0, tk - 1, dh**-0.5, ws.data_ptr(), n_split,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ablation: decode launch failed (n_split {n_split}): "
                                 f"CUDA error {err}")

        rows = []
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.flash_attention_fwd.argtypes = fa_build.LIBRARY.signatures["flash_attention_fwd"]
            splits = DECODE_SPLITS if name == "decode_full" else (chosen,)
            for n_split in splits:
                rows.append((name, n_split, timed(torch, lambda: call(lib, n_split))))
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        rows.append(("sdpa", None, timed(torch, lambda: F.scaled_dot_product_attention(
            qc, kc, vc, enable_gqa=True))))
        for name, n_split, ms in rows:
            print(json.dumps({"ablation": name, "n_split": n_split, "chosen": n_split == chosen,
                              "ms": ms, "bound_ms": bound_ms, "tb_per_s": nbytes / ms / 1e9,
                              "shape": [b, hq, hkv, 1, tk, dh], "device": ident}), flush=True)


def latent_rows(torch, F, fa, fa_build, libs, ident):
    hq, dqk, dv = 128, 576, 512
    device = torch.device("cuda", torch.cuda.current_device())
    sms = fa.sm_count(device)
    per_sm = fa.latent_blocks_per_sm(device, torch.bfloat16, dqk, dv, "latent_wgmma")
    signature = fa_build.MLA_LIBRARY.signatures["flash_attention_mla_fwd"]
    for b, tk in ((8, 32768), (8, 160)):
        gen = torch.Generator(device="cuda").manual_seed(tk)
        q = torch.randn(b, hq, 1, dqk, generator=gen, device="cuda").bfloat16()
        buf = torch.randn(b, tk, dqk, generator=gen, device="cuda").bfloat16()
        k, v = buf[:, None], buf[:, None, :, :dv]
        out = torch.empty((b, 1, hq, dv), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
        strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
        nbytes = (b * tk * dqk + b * hq * (dqk + dv)) * 2  # the latent rows once, q and o
        bound_ms = nbytes / 3.35e12 * 1e3
        chosen = fa.decode_splits(b * fa.latent_blocks(hq, dv, "latent_wgmma"), 1, tk, sms,
                                  per_sm)
        fma_split = fa.decode_splits(
            b * fa.latent_blocks(hq, dv), 1, tk, sms,
            fa.latent_blocks_per_sm(device, torch.bfloat16, dqk, dv))

        def call(lib, variant, n_split):
            ws = torch.empty(b * hq * n_split * (dv + 2), dtype=torch.float32, device="cuda")
            err = lib.flash_attention_mla_fwd(
                fa.VARIANTS.index(variant), 1, dqk, dv, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), strides, b, hq, 1, 1, tk, 1, 0, tk - 1,
                dqk**-0.5, ws.data_ptr(), n_split, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ablation: {variant} launch failed (n_split {n_split}): "
                                 f"CUDA error {err}")

        rows = []
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.flash_attention_mla_fwd.argtypes = signature
            splits = LATENT_SPLITS if name == "latent_full" and tk > 160 else (chosen,)
            for n_split in splits:
                rows.append((name, n_split, timed(torch, lambda: call(lib, "latent_wgmma",
                                                                       n_split))))
        lib = fa_build.mla_library()
        rows.append(("decode_latent", fma_split,
                     timed(torch, lambda: call(lib, "decode_latent", fma_split), reps=5)))
        rows.append(("sdpa", None, timed(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v).transpose(1, 2))))
        for name, n_split, ms in rows:
            print(json.dumps({"ablation": name, "n_split": n_split, "chosen": n_split == chosen,
                              "ms": ms, "bound_ms": bound_ms, "tb_per_s": nbytes / ms / 1e9,
                              "shape": [b, hq, 1, 1, tk, dqk, dv], "device": ident}),
                  flush=True)


def main() -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("prefill", "decode", "latent", "both"), default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.flash_attention import ops as fa

    OUT.mkdir(parents=True, exist_ok=True)
    text = HEADER.read_text()
    cuts = {}
    if args.part in ("prefill", "both"):
        cuts.update(CUTS)
    if args.part in ("decode", "both"):
        cuts.update({"decode_full": [], **DECODE_CUTS})
    if args.part == "latent":
        cuts.update(LATENT_CUTS)
    mla = CSRC / "flash_attention_mla.cu"
    with ThreadPoolExecutor(len(cuts)) as pool:
        libs = dict(zip(cuts, pool.map(lambda kv: build(
            kv[0], cut(text, kv[1]), mla if kv[0] in LATENT_CUTS else SOURCE), cuts.items())))
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.part in ("prefill", "both"):
        prefill_rows(torch, F, fa, fa_build, {n: libs[n] for n in CUTS}, ident)
    if args.part in ("decode", "both"):
        decode_rows(torch, F, fa, fa_build,
                    {n: libs[n] for n in ("decode_full", *DECODE_CUTS)}, ident)
    if args.part == "latent":
        latent_rows(torch, F, fa, fa_build, {n: libs[n] for n in LATENT_CUTS}, ident)
    print(ident)
    return 0


if __name__ == "__main__":
    sys.exit(main())
