"""Mamba-1 block (the falcon-mamba mixer) on the selective-scan kernel.

The full-sequence forward runs one fused scan (``kernels/mamba_scan``) where
the reference runs its chunked associative scan and adds the ``D`` skip
(``_ssm_scan_chunked`` + skip). Decode is one recurrence step on
``(conv_state, ssm_state)`` in plain PyTorch, as in the reference.
``init_mamba`` and ``specs_mamba`` give the block's parameters and their
sharding specs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.launch.mesh import P
from repro_torch.models.layers import Axes, Init


def init_mamba(init: Init, cfg, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    di, n = cfg.mamba_expand * d, cfg.ssm_state
    dt_rank = max(d // 16, 1)
    return {
        "in_proj": init.normal((d, 2 * di), d**-0.5, dtype),
        "conv_w": init.normal((cfg.d_conv, di), 0.1, dtype),
        "conv_b": init.zeros(di, dtype),
        "x_proj": init.normal((di, dt_rank + 2 * n), di**-0.5, dtype),
        "dt_proj": init.normal((dt_rank, di), dt_rank**-0.5, dtype),
        "dt_bias": init.zeros(di, torch.float32),
        "a_log": init.a_log(di, n),
        "d_skip": init.ones(di, torch.float32),
        "out_proj": init.normal((di, d), di**-0.5, dtype),
    }


def specs_mamba(ax: Axes) -> dict:
    return {
        "in_proj": P(ax.dp, ax.tp),
        "conv_w": P(None, ax.tp),
        "conv_b": P(ax.tp),
        "x_proj": P(ax.tp, None),
        "dt_proj": P(None, ax.tp),
        "dt_bias": P(ax.tp),
        "a_log": P(ax.tp, None),
        "d_skip": P(ax.tp),
        "out_proj": P(ax.tp, ax.dp),
    }


def mamba_forward(x: torch.Tensor, p: dict, cfg):
    """Full-sequence Mamba block. x: [B, T, D]. Returns ``(y, (conv_state,
    ssm_state))``. Like the reference, the full-sequence forward does not
    track the final ssm state and returns zeros for it; the decode path
    keeps it step by step."""
    bsz, t, d = x.shape
    di = cfg.mamba_expand * d
    n = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    xz = x @ p["in_proj"]  # [B, T, 2*di]
    xi, z = xz.chunk(2, dim=-1)
    # depthwise causal conv along T
    pad = cfg.d_conv - 1
    xi_pad = F.pad(xi, (0, 0, pad, 0))
    conv = sum(
        xi_pad[:, i : i + t] * p["conv_w"][i][None, None, :] for i in range(cfg.d_conv)
    ) + p["conv_b"]
    xc = F.silu(conv)
    proj = xc @ p["x_proj"]  # [B, T, dt_rank + 2N]
    dt_in = proj[..., :dt_rank]
    b = proj[..., dt_rank : dt_rank + n].float().contiguous()
    c = proj[..., dt_rank + n :].float().contiguous()
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"].to(dt_in.dtype)).float()
    a = -torch.exp(p["a_log"])  # [di, N]
    y, _ = selective_scan(xc.float(), dt.contiguous(), a, b, c, p["d_skip"])
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    conv_state = xi_pad[:, t : t + pad]
    ssm_state = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    return y, (conv_state, ssm_state)


def mamba_decode_step(x: torch.Tensor, p: dict, cfg, conv_state: torch.Tensor,
                      ssm_state: torch.Tensor):
    """One-token step. x: [B, 1, D]; conv_state: [B, d_conv-1, di];
    ssm_state: [B, di, N] float32. Returns ``(y [B, 1, D], (conv, ssm))``."""
    d = x.shape[-1]
    n = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    xz = x[:, 0] @ p["in_proj"]  # [B, 2di]
    xi, z = xz.chunk(2, dim=-1)
    window = torch.cat([conv_state, xi[:, None]], dim=1)  # [B, d_conv, di]
    conv = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(conv)  # [B, di]
    proj = xc @ p["x_proj"]
    dt_in = proj[..., :dt_rank]
    b = proj[..., dt_rank : dt_rank + n].float()
    c = proj[..., dt_rank + n :].float()
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"].to(dt_in.dtype)).float()
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[..., None] * a[None])  # [B, di, N]
    h = da * ssm_state + (dt * xc.float())[..., None] * b[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c) + xc.float() * p["d_skip"][None]
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y[:, None], (window[:, 1:], h)
