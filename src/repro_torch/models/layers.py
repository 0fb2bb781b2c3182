"""Shared layers: RMS norms, RoPE and the dense FFN.

Each upcasts to float32 and casts back exactly where the reference's
``repro.models.layers`` does, so both packages round at the same places.
The expert-parallel MoE waits for its slice (ROADMAP Queue 1 item 8c).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def qk_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3). x: [..., H, Dh]."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T]. Rotates the two halves of
    the head (``x1, x2 = split``), not interleaved pairs."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [Dh/2]
    angles = positions[..., None].float() * freqs  # [..., T, Dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _act(h: torch.Tensor, g: torch.Tensor | None, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(g) * h
    if activation == "gelu":
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    if activation == "sq_relu":
        r = F.relu(h)
        return r * r
    raise ValueError(activation)


def dense_ffn(x: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    h = x @ p["w_in"]
    g = x @ p["w_gate"] if "w_gate" in p else None
    return _act(h, g, activation) @ p["w_out"]
