"""Mamba-1 block (the falcon-mamba mixer) on the selective-scan kernel.

The full-sequence forward runs one fused scan (``kernels/mamba_scan``) where
the reference runs its chunked associative scan and adds the ``D`` skip
(``_ssm_scan_chunked`` + skip). Decode is one recurrence step on
``(conv_state, ssm_state)`` in plain PyTorch, as in the reference.
``init_mamba`` and ``specs_mamba`` give the block's parameters and their
sharding specs.

Tensor-parallel (``tp``, a ``launch.mesh.ModelAxis``, with the specs'
weights split over it): the mixer is one region whose channels split over
the model axis. A rank's ``in_proj`` chunk is contiguous over the ``x ‖
z`` concatenation (on two ranks, all of ``x`` and none of ``z``), so one
all-to-all exchanges it for this rank's ``Di / n`` channels of both halves
(``ModelAxis.channels``): the projection's output where a call has fewer
tokens than ``d_model`` (decode), else the weight chunk, whichever moves
fewer bytes. The convolution, ``dt_proj``'s column chunk, ``A``, ``D`` and
the scan run on those channels; ``x_proj`` (split on its input channels)
gives a partial ``[B, T, dt_rank + 2N]``, summed over the axis before dt,
B and C are read; ``out_proj``'s row chunk gives a partial output, summed
as the region exits. The decode state ``(conv, ssm)`` holds this rank's
channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.launch.mesh import ModelAxis, P
from repro_torch.models.layers import Axes, Init, row_product


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


def _in_proj(x: torch.Tensor, p: dict, tp: ModelAxis) -> torch.Tensor:
    """``x @ in_proj`` ``[..., 2 di]`` laid out ``x ‖ z``, where
    ``tp.split`` this rank's channels of both halves."""
    if not tp.split:
        return x @ p["in_proj"]
    tokens = x[..., 0].numel()
    if tokens < x.shape[-1]:  # fewer bytes: exchange the products
        xz = x @ p["in_proj"]
        return tp.channels(xz.reshape(tokens, -1)).reshape(xz.shape)
    return x @ tp.channels(p["in_proj"])


def _partial_proj(xc: torch.Tensor, p: dict, tp: ModelAxis, dtype: torch.dtype) -> torch.Tensor:
    """``xc @ x_proj`` ``[..., dt_rank + 2N]``; where ``tp.split`` (``xc``
    this rank's channels, ``x_proj`` its rows) the ranks' partials summed,
    the backward summing the ranks' gradients too (each rank reads the sum
    for its own channels)."""
    if not tp.split:
        return xc @ p["x_proj"]
    return tp.sum(row_product(xc, p["x_proj"], True), grad_sum=True).to(dtype)


def mamba_forward(x: torch.Tensor, p: dict, cfg, tp: ModelAxis = ModelAxis()):
    """Full-sequence Mamba block. x: [B, T, D] (under ``"seq"``, this rank's
    stripe). Returns ``(y, (conv_state, ssm_state))``. Like the reference,
    the full-sequence forward does not track the final ssm state and
    returns zeros for it; the decode path keeps it step by step."""
    x = tp.enter(x)
    bsz, t, d = x.shape
    n = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    xz = _in_proj(x, p, tp)  # [B, T, 2*di]
    xi, z = xz.chunk(2, dim=-1)
    di = xi.shape[-1]
    # depthwise causal conv along T
    pad = cfg.d_conv - 1
    xi_pad = F.pad(xi, (0, 0, pad, 0))
    conv = sum(
        xi_pad[:, i : i + t] * p["conv_w"][i][None, None, :] for i in range(cfg.d_conv)
    ) + p["conv_b"]
    xc = F.silu(conv)
    proj = _partial_proj(xc, p, tp, x.dtype)  # [B, T, dt_rank + 2N]
    dt_in = proj[..., :dt_rank]
    b = proj[..., dt_rank : dt_rank + n].float().contiguous()
    c = proj[..., dt_rank + n :].float().contiguous()
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"].to(dt_in.dtype)).float()
    a = -torch.exp(p["a_log"])  # [di, N]
    y, _ = selective_scan(xc.float(), dt.contiguous(), a, b, c, p["d_skip"])
    y = tp.exit(row_product(y.to(x.dtype) * F.silu(z), p["out_proj"], tp.split)).to(x.dtype)
    conv_state = xi_pad[:, t : t + pad]
    ssm_state = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    return y, (conv_state, ssm_state)


def mamba_decode_step(x: torch.Tensor, p: dict, cfg, conv_state: torch.Tensor,
                      ssm_state: torch.Tensor, tp: ModelAxis = ModelAxis()):
    """One-token step. x: [B, 1, D]; conv_state: [B, d_conv-1, di];
    ssm_state: [B, di, N] float32 (where ``tp.split``, this rank's
    channels). Returns ``(y [B, 1, D], (conv, ssm))``."""
    x = tp.enter(x)
    d = x.shape[-1]
    n = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    xz = _in_proj(x[:, 0], p, tp)  # [B, 2di]
    xi, z = xz.chunk(2, dim=-1)
    window = torch.cat([conv_state, xi[:, None]], dim=1)  # [B, d_conv, di]
    conv = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(conv)  # [B, di]
    proj = _partial_proj(xc, p, tp, x.dtype)
    dt_in = proj[..., :dt_rank]
    b = proj[..., dt_rank : dt_rank + n].float()
    c = proj[..., dt_rank + n :].float()
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"].to(dt_in.dtype)).float()
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[..., None] * a[None])  # [B, di, N]
    h = da * ssm_state + (dt * xc.float())[..., None] * b[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c) + xc.float() * p["d_skip"][None]
    y = row_product(y.to(x.dtype) * F.silu(z), p["out_proj"], tp.split)[:, None]
    return tp.exit(y).to(x.dtype), (window[:, 1:], h)
