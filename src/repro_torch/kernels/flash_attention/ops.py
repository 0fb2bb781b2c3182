"""Wrapper of the attention kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/flash_attention.cu``) or the call raises; a CPU tensor takes the
plain PyTorch version in ``ref.py``. There is no fallback from one to the
other. ``launches`` counts the kernel's launches and ``variant_launches``
splits them by the variant that ran; CPU calls do not count.

The variant is picked before the launch by :func:`kernel_variant`, from the
dtype, Tq, g, Dh and the alignment of the tensors alone: a decode step (g *
Tq <= 16) goes to the split-KV decode kernel (``decode_split``), bf16
prefill to the tensor cores (``wgmma_bf16``), the rest to the float32 FMA
kernel in one of its two tilings. A launch error raises; it never sends the
call to another variant.

``decode_split`` cuts the visible key tiles into :func:`decode_splits`
contiguous shares, one block each per (batch, KV head), so that short
batches still fill the card; with more than one share a second, small
kernel merges the shares' partial softmaxes from a float32 workspace that
the wrapper allocates. The split count depends on the shapes alone (Tk, not
the position), so the launch configuration stays the same from one decode
step to the next. A wrapper call counts one launch whether or not the merge
runs; ``split_launches`` counts the decode launches by their split count.

MLA (deepseek-v2-236b) attends with a query and key wider than the value:
``k`` is ``[B, Hkv, Tk, Dqk]`` and ``v`` ``[B, Hkv, Tk, Dv]`` (``v`` may be a
view of ``k``), and the output is ``[B, Hq, Tq, Dv]``. Those pairs are built
in a library of their own (``csrc/flash_attention_mla.cu``), only in the
variants their calls take (``MLA_PAIRS``): the tensor-core and FMA prefill at
(192, 128), and for every call with ``Tq <= 16`` (the absorbed decode step,
128 query heads on one latent KV head at (576, 512), and short prefills) a
latent kernel: ``latent_wgmma`` for bf16 at (576, 512) with aligned inputs
and the value a view of the key's first ``Dv`` columns (tensor cores; one
TMA-staged latent tile feeds both products; a block owns ``LATENT_WGMMA_ROWS``
query rows and all 512 output columns), else ``decode_latent`` (float32 FMA;
``LATENT_ROWS`` rows a block, the output columns cut into slices of
``LATENT_COLS``). A pair or variant that is not built raises before any
launch.

The inputs may be any views whose last dimension is contiguous: the kernel
reads them through their strides, so the model hands it ``[B, T, H, Dh]``
activations and its ``[B, S, Hkv, Dh]`` cache transposed, with no copy. The
output is laid out the same way (``[B, Tq, Hq, Dh]`` in memory, returned as a
``[B, Hq, Tq, Dh]`` view), so the model's ``reshape(B, T, Hq * Dh)`` after it
is free.

Under autograd (grad mode on and an input that requires a gradient) the
launch runs inside :class:`_FlashAttention`: its forward is the kernel, its
backward runs the plain version again on the saved inputs and
differentiates it, as the reference's training forward is differentiated
through its jnp mirrors and never through Pallas. A second derivative
raises. Calls without a gradient launch directly and save nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["DTYPES", "HEAD_DIMS", "MLA_PAIRS", "VARIANTS", "decode_blocks_per_sm",
           "decode_splits", "flash_attention", "is_aligned", "kernel_variant",
           "latent_blocks", "latent_blocks_per_sm", "launches", "reset", "sm_count",
           "split_launches", "value_in_key", "variant_launches"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128, 256)  # every variant is built at each, Dqk = Dv
# MLA's (Dqk, Dv) pairs and the variants built at each, in both dtypes
# (wgmma_bf16 in bf16): deepseek-v2-236b's prefill and absorbed decode, and
# its reduced config's pair for both
MLA_PAIRS = {
    (192, 128): ("fma", "wgmma_bf16", "decode_latent"),
    (576, 512): ("decode_latent", "latent_wgmma"),
    (48, 32): ("fma", "decode_latent"),
}
# the kernel's variants, in the order of their codes in csrc/flash_attention.cuh
VARIANTS = ("fma", "fma_short", "decode_split", "wgmma_bf16", "decode_latent", "latent_wgmma")
# the variants that split the cache into shares (n_split) and merge them
SPLIT_VARIANTS = ("decode_split", "decode_latent", "latent_wgmma")
TILE_KEYS = 64  # keys a tile of every variant
# decode_latent: query rows and output columns a block (kLatBR, kLatDVS)
LATENT_ROWS = 64
LATENT_COLS = 128
# latent_wgmma: query rows a block (kLwBR); every block holds all Dv columns
LATENT_WGMMA_ROWS = 64
# decode_split: every share gets at least this many tiles
DECODE_MIN_TILES_PER_SPLIT = 16
launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
split_launches: dict[int, int] = {}  # SPLIT_VARIANTS' launches by their n_split


def reset() -> None:
    """Zero the launch counts."""
    global launches
    launches = 0
    for name in VARIANTS:
        variant_launches[name] = 0
    split_launches.clear()


def is_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every base pointer and every batch, head and row stride is a
    multiple of 16 bytes: what the tensor-core kernel's TMA copies need."""
    return all(t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                              for s in t.stride()[:3]) for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device, read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _decode_blocks_per_sm(index: int, dtype: torch.dtype, dh: int, rows: int) -> int:
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.library().flash_decode_blocks_per_sm(DTYPES[dtype], dh, rows,
                                                         ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"decode_split occupancy query failed: CUDA error {err}, "
                           f"{blocks.value} blocks an SM")
    return blocks.value


def decode_blocks_per_sm(device: torch.device, dtype: torch.dtype, dh: int, rows: int) -> int:
    """The ``decode_split`` blocks that one SM of a CUDA device holds at once,
    for ``g * Tq = rows`` query rows at this dtype and head dim: what the
    instance's shared-memory ring and registers allow (the CUDA occupancy
    query), read once per device and instance."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _decode_blocks_per_sm(index, dtype, dh, rows)


@functools.lru_cache(maxsize=None)
def _latent_blocks_per_sm(index: int, dtype: torch.dtype, dqk: int, dv: int,
                          variant: str) -> int:
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.mla_library().flash_latent_blocks_per_sm(
            VARIANTS.index(variant), DTYPES[dtype], dqk, dv, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"{variant} occupancy query failed: CUDA error {err}, "
                           f"{blocks.value} blocks an SM")
    return blocks.value


def latent_blocks_per_sm(device: torch.device, dtype: torch.dtype, dqk: int, dv: int,
                         variant: str = "decode_latent") -> int:
    """The ``variant`` (``decode_latent`` or ``latent_wgmma``) blocks that
    one SM of a CUDA device holds at once at this dtype and (Dqk, Dv) pair
    (the CUDA occupancy query), read once per device and instance."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _latent_blocks_per_sm(index, dtype, dqk, dv, variant)


def latent_blocks(rows: int, dv: int, variant: str = "decode_latent") -> int:
    """The blocks of one (batch, KV head) and share: ``decode_latent`` cuts
    its ``rows = g * Tq`` query rows into tiles of ``LATENT_ROWS`` and its
    ``dv`` output columns into slices of ``LATENT_COLS``; ``latent_wgmma``
    cuts the rows into tiles of ``LATENT_WGMMA_ROWS`` and keeps every column
    in each block."""
    if variant == "latent_wgmma":
        return -(-rows // LATENT_WGMMA_ROWS)
    return -(-rows // LATENT_ROWS) * (dv // min(dv, LATENT_COLS))


def value_in_key(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether ``v`` is the first ``Dv`` columns of ``k`` (the same base and
    batch, head and row strides), as MLA's absorbed decode hands over its
    latent cache: what ``latent_wgmma`` reads the value from."""
    return v.data_ptr() == k.data_ptr() and v.stride()[:3] == k.stride()[:3]


def decode_splits(batch: int, hkv: int, tk: int, sm_count: int, blocks_per_sm: int) -> int:
    """How many contiguous shares of the key tiles ``decode_split`` gives a
    (batch, KV head), from the shapes alone: as many as one round of
    resident blocks (``sm_count * blocks_per_sm``) holds for ``batch * hkv``
    of them, at least 1, and at most one share per
    ``DECODE_MIN_TILES_PER_SPLIT`` tiles (so 1 for the serve loop's short
    caches and where ``batch * hkv`` already fills the card)."""
    most = -(-tk // TILE_KEYS) // DECODE_MIN_TILES_PER_SPLIT
    return max(1, min(most, sm_count * blocks_per_sm // max(batch * hkv, 1)))


def kernel_variant(dtype: torch.dtype, tq: int, group: int, dh: int, aligned: bool,
                   dv: int | None = None, shared_value: bool = True) -> str:
    """The kernel variant for these inputs (``dh`` the query/key width,
    ``dv`` the value's, ``dh`` when None): at ``dh == dv``, ``decode_split``
    when ``g * Tq <= 16`` (a decode step: the g query heads of a KV head in
    one block, the cache split over blocks), ``fma_short`` when ``Tq <= 16``
    (16-row tiles), ``wgmma_bf16`` (tensor cores) for bf16 with 16-byte
    aligned pointers and strides, else ``fma`` (float32 FMA, 64-row tiles);
    ``decode_split`` takes unaligned rows too, with element loads. At an MLA
    pair, when ``Tq <= 16`` (the absorbed decode step, g = 128, and short
    prefills): ``latent_wgmma`` where the pair has it (576, 512) and the
    inputs are bf16, aligned and ``shared_value`` (v a view of k's first
    columns, :func:`value_in_key`), else ``decode_latent``; for longer
    prompts ``wgmma_bf16`` where the pair has it and the inputs are bf16 and
    aligned, else ``fma``."""
    if dv is not None and dv != dh:
        built = MLA_PAIRS.get((dh, dv), ())
        bf16_aligned = dtype == torch.bfloat16 and aligned
        if tq <= 16:
            if bf16_aligned and shared_value and "latent_wgmma" in built:
                return "latent_wgmma"
            return "decode_latent"
        if bf16_aligned and "wgmma_bf16" in built:
            return "wgmma_bf16"
        return "fma"
    if group * tq <= 16:
        return "decode_split"
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
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k must be [B, Hkv, Tk, {dh}] and v [B, Hkv, Tk, Dv], with B = {b}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"Hq = {hq} must be a multiple of Hkv = {k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Tq, Dqk]
    k: torch.Tensor,  # [B, Hkv, Tk, Dqk]
    v: torch.Tensor,  # [B, Hkv, Tk, Dv]
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention of query row ``i`` (absolute position ``q_offset +
    i``) over the keys that the masks keep: causal ``kpos <= qpos``, a
    sliding ``window`` ``kpos > qpos - window``; ``Hq / Hkv`` query heads
    share a key/value head; scores scaled by ``Dqk ** -0.5``. Returns ``[B,
    Hq, Tq, Dv]`` in ``q``'s dtype (float32 statistics inside). On a CUDA
    tensor that needs a gradient the output carries one (the plain
    version's, recomputed)."""
    _check(q, k, v, window)
    device = q.device
    if device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {sorted(map(str, DTYPES))}, got {q.dtype}")
    dqk, dv = q.shape[3], v.shape[3]
    if dqk == dv and dqk not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {dqk}")
    if dqk != dv and (dqk, dv) not in MLA_PAIRS:
        raise ValueError(f"the kernel takes (Dqk, Dv) pairs {sorted(MLA_PAIRS)} where Dqk != Dv, "
                         f"got {(dqk, dv)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last dimension")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _launch(q, k, v, causal, window, q_offset)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.masks = (causal, window, q_offset)
        return _launch(q, k, v, causal, window, q_offset)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = flash_attention_ref(*inputs, *ctx.masks)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def _launch(q, k, v, causal, window, q_offset) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors."""
    global launches
    device = q.device
    b, hq, tq, dh = q.shape
    dv = v.shape[3]
    out = torch.empty((b, tq, hq, dv), dtype=q.dtype, device=device).transpose(1, 2)
    if tq == 0:
        return out
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    variant = kernel_variant(q.dtype, tq, g, dh, is_aligned(q, k, v, out), dv,
                             value_in_key(k, v))
    if dh != dv and variant not in MLA_PAIRS[(dh, dv)]:
        raise ValueError(f"the {variant} variant is not built at (Dqk, Dv) = {(dh, dv)} "
                         f"({q.dtype}, Tq = {tq}); it has {MLA_PAIRS[(dh, dv)]}")
    n_split, workspace = 1, None
    if variant in SPLIT_VARIANTS:
        if variant == "decode_split":
            blocks, per_sm = b, decode_blocks_per_sm(device, q.dtype, dh, g * tq)
        else:
            blocks = b * latent_blocks(g * tq, dv, variant)
            per_sm = latent_blocks_per_sm(device, q.dtype, dh, dv, variant)
        n_split = decode_splits(blocks, hkv, tk, sm_count(device), per_sm)
        if n_split > 1:  # each share's (o, m, l) per query row, merged by a second kernel
            workspace = torch.empty(b * hq * tq * n_split * (dv + 2), dtype=torch.float32,
                                    device=device)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, hq, hkv, tq, tk, int(bool(causal)), window or 0, int(q_offset),
            dh**-0.5, None if workspace is None else workspace.data_ptr(), n_split,
            torch.cuda.current_stream(device).cuda_stream)
    if dh == dv:
        err = build.library().flash_attention_fwd(VARIANTS.index(variant), DTYPES[q.dtype], dh,
                                                  *args)
    else:
        err = build.mla_library().flash_attention_mla_fwd(VARIANTS.index(variant),
                                                          DTYPES[q.dtype], dh, dv, *args)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch failed: CUDA error {err}")
    launches += 1
    variant_launches[variant] += 1
    if variant in SPLIT_VARIANTS:
        split_launches[n_split] = split_launches.get(n_split, 0) + 1
    return out
