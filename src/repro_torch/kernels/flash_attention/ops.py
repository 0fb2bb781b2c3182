"""Wrapper of the attention kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/flash_attention.cu``) or the call raises; a CPU tensor takes the
plain PyTorch version in ``ref.py``. There is no fallback from one to the
other. ``launches`` counts the kernel's launches and ``variant_launches``
splits them by the variant that ran; CPU calls do not count.

The variant is picked before the launch by :func:`kernel_variant`, from the
dtype, Tq, g, Dh and the alignment of the tensors alone: bf16 prefill goes
to the tensor cores (``wgmma_bf16``), float32 and decode to the float32 FMA
kernel in one of its three tilings. A launch error raises; it never sends
the call to another variant.

The inputs may be any views whose last dimension is contiguous: the kernel
reads them through their strides, so the model hands it ``[B, T, H, Dh]``
activations and its ``[B, S, Hkv, Dh]`` cache transposed, with no copy. The
output is laid out the same way (``[B, Tq, Hq, Dh]`` in memory, returned as a
``[B, Hq, Tq, Dh]`` view), so the model's ``reshape(B, T, Hq * Dh)`` after it
is free.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["DTYPES", "HEAD_DIMS", "VARIANTS", "flash_attention", "is_aligned", "kernel_variant",
           "launches", "reset", "variant_launches"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
# the kernel's variants, in the order of their codes in csrc/flash_attention.cu
VARIANTS = ("fma", "fma_short", "fma_grouped", "wgmma_bf16")
launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)


def reset() -> None:
    """Zero the launch counts."""
    global launches
    launches = 0
    for name in VARIANTS:
        variant_launches[name] = 0


def is_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every base pointer and every batch, head and row stride is a
    multiple of 16 bytes: what the tensor-core kernel's TMA copies need."""
    return all(t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                              for s in t.stride()[:3]) for t in tensors)


def kernel_variant(dtype: torch.dtype, tq: int, group: int, dh: int, aligned: bool) -> str:
    """The kernel variant for these inputs: ``fma_grouped`` when ``g * Tq <=
    16`` (a decode step: the g query heads of a KV head in one block),
    ``fma_short`` when ``Tq <= 16`` (16-row tiles), ``wgmma_bf16`` (tensor
    cores) for bf16 with 16-byte aligned pointers and strides, else ``fma``
    (float32 FMA, 64-row tiles)."""
    if group * tq <= 16:
        return "fma_grouped"
    if tq <= 16:
        return "fma_short"
    if dtype == torch.bfloat16 and dh in HEAD_DIMS and aligned:
        return "wgmma_bf16"
    return "fma"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"q, k and v must share dtype and device; {name} is "
                             f"{t.dtype} on {t.device}, q {q.dtype} on {q.device}")
    b, hq, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k and v must be [B, Hkv, Tk, {dh}] with B = {b}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"Hq = {hq} must be a multiple of Hkv = {k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Tq, Dh]
    k: torch.Tensor,  # [B, Hkv, Tk, Dh]
    v: torch.Tensor,  # [B, Hkv, Tk, Dh]
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention of query row ``i`` (absolute position ``q_offset +
    i``) over the keys that the masks keep: causal ``kpos <= qpos``, a
    sliding ``window`` ``kpos > qpos - window``; ``Hq / Hkv`` query heads
    share a key/value head. Returns ``[B, Hq, Tq, Dh]`` in ``q``'s dtype
    (float32 statistics inside)."""
    global launches
    _check(q, k, v, window)
    device = q.device
    if device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {sorted(map(str, DTYPES))}, got {q.dtype}")
    b, hq, tq, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {dh}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last dimension")
    out = torch.empty((b, tq, hq, dh), dtype=q.dtype, device=device).transpose(1, 2)
    if tq == 0:
        return out
    hkv = k.shape[1]
    variant = kernel_variant(q.dtype, tq, hq // hkv, dh, is_aligned(q, k, v, out))
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = build.library().flash_attention_fwd(
        VARIANTS.index(variant), DTYPES[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), strides,
        b, hq, hkv, tq, k.shape[2], int(bool(causal)), window or 0, int(q_offset),
        dh**-0.5, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch failed: CUDA error {err}")
    launches += 1
    variant_launches[variant] += 1
    return out
