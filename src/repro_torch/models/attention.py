"""GQA attention (qk-norm, sliding window) and gated cross-attention on the
flash-attention kernel.

One kernel serves every regime the reference splits three ways: prefill of
any length (the reference's ``_sdpa`` below 8192 tokens, ``_chunked_sdpa``
from there) and the one-token decode step (the reference's sharded
``gqa_flash_decode``, here on one card). The kernel reads the model's
``[B, T, H, Dh]`` tensors and ``[B, S, Hkv, Dh]`` cache through their
strides, so no layout copy is made.

Cross-attention (llama-3.2-vision's image layers) is ``gqa_forward`` with
``kv_x``: keys and values from the image embeddings, no RoPE, no mask (one
bidirectional launch with ``Tq = T``, ``Tk = n_img_tokens``), and the output
scaled by ``tanh(gate)`` where the layer has a gate. Its decode step
(``gqa_cross_decode``) attends over the image K/V the caller cached, as the
reference's ``_plain_cross_decode``. MLA and the reference's
sequence-parallel mode wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import LATER_ITEM
from repro_torch.models.layers import apply_rope, qk_head_norm


def _gated(y: torch.Tensor, p: dict) -> torch.Tensor:
    """``tanh(gate) * y`` where the layer has a gate (tanh in float32, cast
    to ``y``'s dtype, as the reference)."""
    if "gate" not in p:
        return y
    return torch.tanh(p["gate"].float()).to(y.dtype) * y


def gqa_forward(x: torch.Tensor, p: dict, cfg, window: int | None, kv_x=None,
                causal: bool | None = None, seq_axes=None):
    """Full-sequence attention (prefill). x: [B, T, D]; ``kv_x`` [B, S, D]
    the cross-attention source (cast to ``x``'s dtype: the kernel takes one
    dtype). Returns ``(y [B, T, D], (k, v))`` with k, v ``[B, S, Hkv, Dh]``."""
    if seq_axes is not None:
        raise NotImplementedError(
            "sequence-parallel attention needs a mesh; the port runs on one card")
    if cfg.use_mla:
        raise NotImplementedError(f"MLA is not ported yet; {LATER_ITEM}")
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x.to(x.dtype)
    s = src.shape[1]
    q = (x @ p["wq"]).reshape(b, t, h, dh)
    k = (src @ p["wk"]).reshape(b, s, hkv, dh)
    v = (src @ p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:  # before RoPE, as qwen3 does
        q = qk_head_norm(q, p["q_scale"])
        k = qk_head_norm(k, p["k_scale"])
    if kv_x is None:  # self-attention gets RoPE
        pos = torch.arange(t, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    is_causal = (cfg.causal if causal is None else causal) and kv_x is None
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=is_causal, window=window)
    y = out.transpose(1, 2).reshape(b, t, h * dh) @ p["wo"]
    if kv_x is not None:
        y = _gated(y, p)
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


def gqa_cross_decode(h: torch.Tensor, p: dict, cfg, k_img: torch.Tensor,
                     v_img: torch.Tensor) -> torch.Tensor:
    """One decode step of a cross-attention layer (the reference's
    ``_plain_cross_decode``): the query of ``h`` [B, 1, D] (qk-norm, no
    RoPE) over every cached image key ``[B, N, Hkv, Dh]``, one bidirectional
    launch, then ``wo`` and the gate. Returns ``y`` [B, 1, D]."""
    b = h.shape[0]
    hq, dh = cfg.n_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(b, 1, hq, dh)
    if cfg.qk_norm:
        q = qk_head_norm(q, p["q_scale"])
    out = flash_attention(q.transpose(1, 2), k_img.transpose(1, 2), v_img.transpose(1, 2),
                          causal=False)
    return _gated(out.transpose(1, 2).reshape(b, 1, hq * dh) @ p["wo"], p)
