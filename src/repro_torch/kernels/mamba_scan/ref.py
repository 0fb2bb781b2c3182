"""Plain PyTorch version of the selective-scan kernel.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      h: [D, N]
    y_t = (h_t @ C_t) + D_skip * x_t                        y: [D]

A loop over time in float32, one step per iteration, as the reference's
``selective_scan_ref`` scans. The wrapper in ``ops.py`` takes this for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import torch


def selective_scan_ref(
    x: torch.Tensor,  # [B, T, D]
    dt: torch.Tensor,  # [B, T, D] (already softplus'd)
    a: torch.Tensor,  # [D, N] (negative: the state's decay)
    b: torch.Tensor,  # [B, T, N]
    c: torch.Tensor,  # [B, T, N]
    d_skip: torch.Tensor,  # [D]
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, T, D] in x's dtype, h_T [B, D, N] float32)`` from ``h_0 = 0``."""
    bsz, t, d = x.shape
    xf, dtf = x.float(), dt.float()
    af, bf, cf = a.float(), b.float(), c.float()
    h = torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        da = torch.exp(dtf[:, i, :, None] * af)  # [B, D, N]
        h = da * h + (dtf[:, i] * xf[:, i])[:, :, None] * bf[:, i, None, :]
        ys.append((h * cf[:, i, None, :]).sum(-1))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((bsz, 0, d))
    y = y + xf * d_skip.float()[None, None, :]
    return y.to(x.dtype), h
