"""GQA self-attention (qk-norm, sliding window) on the flash-attention kernel.

One kernel serves every regime the reference splits three ways: prefill of
any length (the reference's ``_sdpa`` below 8192 tokens, ``_chunked_sdpa``
from there) and the one-token decode step (the reference's sharded
``gqa_flash_decode``, here on one card). The kernel reads the model's
``[B, T, H, Dh]`` tensors and ``[B, S, Hkv, Dh]`` cache through their
strides, so no layout copy is made. Cross-attention, MLA and the reference's
sequence-parallel mode wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import LATER_ITEM
from repro_torch.models.layers import apply_rope, qk_head_norm


def gqa_forward(x: torch.Tensor, p: dict, cfg, window: int | None, kv_x=None,
                causal: bool | None = None, seq_axes=None):
    """Full-sequence self-attention (prefill). x: [B, T, D]. Returns
    ``(y [B, T, D], (k, v))`` with k, v ``[B, T, Hkv, Dh]``."""
    if kv_x is not None:
        raise NotImplementedError(f"cross-attention is not ported yet; {LATER_ITEM}")
    if seq_axes is not None:
        raise NotImplementedError(
            "sequence-parallel attention needs a mesh; the port runs on one card")
    if cfg.use_mla:
        raise NotImplementedError(f"MLA is not ported yet; {LATER_ITEM}")
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, t, h, dh)
    k = (x @ p["wk"]).reshape(b, t, hkv, dh)
    v = (x @ p["wv"]).reshape(b, t, hkv, dh)
    if cfg.qk_norm:  # before RoPE, as qwen3 does
        q = qk_head_norm(q, p["q_scale"])
        k = qk_head_norm(k, p["k_scale"])
    pos = torch.arange(t, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    is_causal = cfg.causal if causal is None else causal
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=is_causal, window=window)
    y = out.transpose(1, 2).reshape(b, t, h * dh) @ p["wo"]
    return y, (k, v)


def gqa_flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                     window: int | None) -> torch.Tensor:
    """One decode step over the whole cache. q: [B, H, Dh]; caches
    ``[B, S, Hkv, Dh]`` holding positions ``0..pos``. Keys ``kpos <= pos``
    (and ``kpos > pos - window``) count, as in the reference's
    ``gqa_flash_decode`` with one stripe. Returns ``[B, H, Dh]``."""
    out = flash_attention(q[:, :, None, :], k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                          causal=True, window=window, q_offset=pos)
    return out[:, :, 0]
