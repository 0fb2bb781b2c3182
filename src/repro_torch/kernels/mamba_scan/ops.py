"""Wrapper of the selective-scan kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/mamba_scan.cu``) or the call raises; a CPU tensor takes the plain
PyTorch version in ``ref.py``. There is no fallback from one to the other.
``launches`` counts the kernel's launches; CPU calls do not count.

Under autograd (grad mode on and an input that requires a gradient) the
launch runs inside :class:`_SelectiveScan`: its forward is the kernel, its
backward runs the plain version again on the saved inputs and
differentiates it (the reference differentiates its jnp scan, never the
Pallas kernel). A second derivative raises. Calls without a gradient launch
directly and save nothing.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import check_tensor as _check
from repro_torch.kernels.mamba_scan import build
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

__all__ = ["DTYPES", "STATES_PER_THREAD", "STATE_SIZES", "launches", "reset", "selective_scan"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZES = (8, 16)
# the kernel's split of the work (csrc/mamba_scan.cu's kStates): a thread
# holds min(STATES_PER_THREAD, N) states of one channel
STATES_PER_THREAD = 4
launches = 0


def reset() -> None:
    """Zero the launch count."""
    global launches
    launches = 0


def selective_scan(
    x: torch.Tensor,  # [B, T, D]
    dt: torch.Tensor,  # [B, T, D]
    a: torch.Tensor,  # [D, N] float32
    b: torch.Tensor,  # [B, T, N]
    c: torch.Tensor,  # [B, T, N]
    d_skip: torch.Tensor,  # [D] float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, T, D], h_T [B, D, N])``: the Mamba-1 scan from a zero state
    with the ``D`` skip, ``y`` in ``x``'s dtype and ``h_T`` in float32.
    ``x``, ``dt``, ``b`` and ``c`` share one dtype; all inputs contiguous.
    On CUDA tensors that need a gradient both outputs carry one (the plain
    version's, recomputed)."""
    device = x.device
    _check("x", x, x.dtype, 3, device)
    bsz, t, d = x.shape
    _check("dt", dt, x.dtype, 3, device)
    _check("a", a, torch.float32, 2, device)
    n = a.shape[1]
    _check("b", b, x.dtype, 3, device)
    _check("c", c, x.dtype, 3, device)
    _check("d_skip", d_skip, torch.float32, 1, device)
    if dt.shape != x.shape or a.shape[0] != d or b.shape != (bsz, t, n) or c.shape != b.shape \
            or d_skip.shape != (d,):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"b {tuple(b.shape)}, c {tuple(c.shape)}, d_skip {tuple(d_skip.shape)}")
    if device.type == "cpu":
        return selective_scan_ref(x, dt, a, b, c, d_skip)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {sorted(map(str, DTYPES))}, got {x.dtype}")
    if n not in STATE_SIZES:
        raise ValueError(f"the kernel takes state sizes {STATE_SIZES}, got {n}")
    inputs = (x, dt, a, b, c, d_skip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _SelectiveScan.apply(*inputs)
    return _launch(*inputs)


class _SelectiveScan(torch.autograd.Function):
    """The kernel forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return _launch(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_y, grad_h):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y, h_last = selective_scan_ref(*inputs)
            grads = iter(torch.autograd.grad((y, h_last), wanted, (grad_y, grad_h)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def _launch(x, dt, a, b, c, d_skip) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on checked CUDA tensors."""
    global launches
    device = x.device
    bsz, t, d = x.shape
    n = a.shape[1]
    y = torch.empty_like(x)
    h_last = torch.empty((bsz, d, n), dtype=torch.float32, device=device)
    if bsz == 0 or d == 0:
        return y, h_last
    err = build.library().selective_scan_fwd(
        DTYPES[x.dtype], n, x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h_last.data_ptr(), bsz, t, d,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, h_last
