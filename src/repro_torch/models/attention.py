"""GQA attention (qk-norm, sliding window), gated cross-attention and MLA on
the flash-attention kernel.

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
reference's ``_plain_cross_decode``.

MLA (deepseek-v2-236b) takes the same kernel at (Dqk, Dv) pairs where the
query and key are wider than the value: prefill in the expanded form
(``mla_forward``: 128 nope + 64 rope query/key columns against 128 value
columns a head, one launch a layer), the decode step in the absorbed form
(``mla_flash_decode``: all 128 query heads against the one latent KV head,
576 key columns of which the first 512 are the value, one launch over the
latent cache).

Sequence-parallel (``stripe``, ``activation_partitioning="seq"`` on a model
axis larger than 1): ``x`` is the rank's stripe of the positions. Queries
stay local, RoPE'd at the stripe's positions; the keys and values (after
qk-norm and RoPE) are all-gathered over the model axis, and one launch runs
the stripe's rows against the whole sequence at ``q_offset`` = the
stripe's start (causal and windowed masks at absolute positions). MLA
gathers its latent (``c_kv`` and the RoPE'd ``k_pe``, 576 values a token at
full width) and expands it on every rank, where gathering the expanded keys
and values would move 128 heads x 320 values a token: the same values, 71x
fewer bytes. Cross-attention's keys and values come from the image
embeddings, which are not split: the stripe's queries attend to them all.

``init_attention`` and ``specs_attention`` give a layer's parameters and
their sharding specs (the GQA, cross and MLA variants).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.mesh import P, Stripe
from repro_torch.models.layers import Axes, Init, apply_rope, qk_head_norm, rms_norm


def init_attention(init: Init, cfg, dtype: torch.dtype, cross: bool = False) -> dict:
    d = cfg.d_model
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d**-0.5
    if cfg.use_mla and not cross:
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        p = {
            "wkv_a": init.normal((d, r + rope_d), s, dtype),
            "kv_norm": init.ones(r, dtype),
            "wkv_b": init.normal((r, h * (nope + vd)), r**-0.5, dtype),
            "wo": init.normal((h * vd, d), (h * vd) ** -0.5, dtype),
        }
        if qr:
            p["wq_a"] = init.normal((d, qr), s, dtype)
            p["q_norm"] = init.ones(qr, dtype)
            p["wq_b"] = init.normal((qr, h * (nope + rope_d)), qr**-0.5, dtype)
        else:
            p["wq"] = init.normal((d, h * (nope + rope_d)), s, dtype)
        return p
    p = {
        "wq": init.normal((d, h * dh), s, dtype),
        "wk": init.normal((d, hkv * dh), s, dtype),
        "wv": init.normal((d, hkv * dh), s, dtype),
        "wo": init.normal((h * dh, d), (h * dh) ** -0.5, dtype),
    }
    if cfg.qk_norm:
        p["q_scale"] = init.ones(dh, dtype)
        p["k_scale"] = init.ones(dh, dtype)
    if cross and cfg.cross_attn_gated:
        p["gate"] = init.zeros(1, dtype)  # tanh(0): the image path starts closed
    return p


def specs_attention(cfg, ax: Axes, cross: bool = False) -> dict:
    if cfg.use_mla and not cross:
        p = {"wkv_a": P(ax.dp, None), "kv_norm": P(None), "wkv_b": P(ax.dp, ax.tp),
             "wo": P(ax.tp, ax.dp)}
        if cfg.q_lora_rank:
            p["wq_a"] = P(ax.dp, None)
            p["q_norm"] = P(None)
            p["wq_b"] = P(ax.dp, ax.tp)
        else:
            p["wq"] = P(ax.dp, ax.tp)
        return p
    if cfg.attn_weight_shard == "f" and not cross:
        full = (*ax.dp, ax.tp)
        p = {"wq": P(None, full), "wk": P(None, full), "wv": P(None, full), "wo": P(full, None)}
    else:
        p = {"wq": P(ax.dp, ax.tp), "wk": P(ax.dp, ax.tp), "wv": P(ax.dp, ax.tp),
             "wo": P(ax.tp, ax.dp)}
    if cfg.qk_norm:
        p["q_scale"] = P(None)
        p["k_scale"] = P(None)
    if cross and cfg.cross_attn_gated:
        p["gate"] = P(None)
    return p


def _gated(y: torch.Tensor, p: dict) -> torch.Tensor:
    """``tanh(gate) * y`` where the layer has a gate (tanh in float32, cast
    to ``y``'s dtype, as the reference)."""
    if "gate" not in p:
        return y
    return torch.tanh(p["gate"].float()).to(y.dtype) * y


def gqa_forward(x: torch.Tensor, p: dict, cfg, window: int | None, kv_x=None,
                causal: bool | None = None, stripe: Stripe | None = None):
    """Full-sequence attention (prefill). x: [B, T, D], or this rank's stripe
    ``[B, T_r, D]`` of the positions with ``stripe``; ``kv_x`` [B, S, D]
    the cross-attention source (cast to ``x``'s dtype: the kernel takes one
    dtype). Returns ``(y [B, T, D] (T_r with a stripe), (k, v))`` with k, v
    ``[B, S, Hkv, Dh]`` over the whole sequence."""
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
    start = 0
    if kv_x is None:  # self-attention gets RoPE
        start = stripe.start if stripe is not None else 0
        pos = torch.arange(start, start + t, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        if stripe is not None:  # the whole sequence's keys and values, one gather
            kv = stripe.gather(torch.cat([k, v], -1))
            k, v = kv[..., :dh], kv[..., dh:]
    is_causal = (cfg.causal if causal is None else causal) and kv_x is None
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=is_causal, window=window, q_offset=start)
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


# ----------------------------------------------------------------- MLA paths
def mla_q(x: torch.Tensor, p: dict, cfg, pos: torch.Tensor) -> torch.Tensor:
    """MLA's query ``[B, T, H, nope + rope]``, its rope part RoPE'd at ``pos``."""
    b, t, _ = x.shape
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        qa = rms_norm(x @ p["wq_a"], {"scale": p["q_norm"]})
        q = (qa @ p["wq_b"]).reshape(b, t, cfg.n_heads, nope + rope_d)
    else:
        q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, nope + rope_d)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    return torch.cat([q_nope, apply_rope(q_pe, pos, cfg.rope_theta)], -1)


def mla_latent(x: torch.Tensor, p: dict, cfg, pos: torch.Tensor):
    """What MLA's decode cache keeps: ``c_kv`` [B, T, r] (normed) and the
    key's rope part ``k_pe`` [B, T, rope], RoPE'd at ``pos``."""
    r = cfg.kv_lora_rank
    kv_a = x @ p["wkv_a"]  # [B, T, r + rope]
    c_kv = rms_norm(kv_a[..., :r], {"scale": p["kv_norm"]})
    k_pe = apply_rope(kv_a[..., None, r:], pos, cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def mla_kv(c_kv: torch.Tensor, k_pe: torch.Tensor, p: dict, cfg):
    """The expanded key ``[B, T, H, nope + rope]`` (the rope part broadcast
    over the heads) and value ``[B, T, H, v_head_dim]`` (a view of the
    ``wkv_b`` product, no copy) of the latent."""
    b, t, _ = c_kv.shape
    h, nope, rope_d = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kv = (c_kv @ p["wkv_b"]).reshape(b, t, h, nope + cfg.v_head_dim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, t, h, rope_d)], -1)
    return k, v


def mla_qkv(x: torch.Tensor, p: dict, cfg):
    """Expanded-form MLA projections for prefill, as the reference's: q and k
    ``[B, T, H, nope + rope]`` (the rope key broadcast over the heads), v
    ``[B, T, H, v_head_dim]`` (a view of the ``wkv_b`` product, no copy), and
    what the decode cache keeps, ``c_kv`` [B, T, r] and ``k_pe`` [B, T, rope]."""
    pos = torch.arange(x.shape[1], device=x.device)
    c_kv, k_pe = mla_latent(x, p, cfg, pos)
    k, v = mla_kv(c_kv, k_pe, p, cfg)
    return mla_q(x, p, cfg, pos), k, v, c_kv, k_pe


def mla_forward(x: torch.Tensor, p: dict, cfg, window: int | None = None,
                stripe: Stripe | None = None):
    """Full-sequence MLA (prefill): one launch at (Dqk, Dv) = (nope + rope,
    v_head_dim), scaled by (nope + rope)^-0.5 as the reference's ``_sdpa``
    scales by its query's width. The reference switches to ``_chunked_sdpa``
    from 8,192 tokens; the kernel covers both. With ``stripe``, ``x`` is the
    rank's stripe of the positions and the latent is gathered whole before
    it is expanded. Returns ``(y [B, T, D] (T_r with a stripe), (c_kv,
    k_pe))``, the latent over the whole sequence."""
    b, t, _ = x.shape
    if stripe is None:
        q, k, v, c_kv, k_pe = mla_qkv(x, p, cfg)
    else:
        pos = torch.arange(stripe.start, stripe.start + t, device=x.device)
        c_kv, k_pe = mla_latent(x, p, cfg, pos)
        r = c_kv.shape[-1]
        latent = stripe.gather(torch.cat([c_kv, k_pe], -1))
        c_kv, k_pe = latent[..., :r], latent[..., r:]
        k, v = mla_kv(c_kv, k_pe, p, cfg)
        q = mla_q(x, p, cfg, pos)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=cfg.causal, window=window,
                          q_offset=stripe.start if stripe is not None else 0)
    y = out.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.v_head_dim) @ p["wo"]
    return y, (c_kv, k_pe)


def latent_buffer(ckv: torch.Tensor, kpe: torch.Tensor) -> torch.Tensor:
    """The ``[B, S, r + rope]`` latent cache whose first ``r`` columns are
    ``ckv`` and the rest ``kpe``: a view when the two are views of one
    buffer (what ``Model.init_cache`` gives), else their concatenation."""
    from torch._subclasses.fake_tensor import FakeTensor

    r = ckv.shape[-1]
    if isinstance(ckv, FakeTensor):  # a dry run's shapes: no storage to share
        return torch.cat([ckv, kpe], -1)
    if (ckv.untyped_storage().data_ptr() == kpe.untyped_storage().data_ptr()
            and ckv.stride() == kpe.stride() and ckv.stride(-1) == 1
            and kpe.storage_offset() == ckv.storage_offset() + r
            and ckv.stride(1) >= r + kpe.shape[-1]):
        return ckv.as_strided((*ckv.shape[:2], r + kpe.shape[-1]), ckv.stride(),
                              ckv.storage_offset())
    return torch.cat([ckv, kpe], -1)


def mla_flash_decode(q_lat: torch.Tensor, q_pe: torch.Tensor, ckv_cache: torch.Tensor,
                     kpe_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Absorbed-form MLA decode over the latent cache, one launch: q_lat
    [B, H, r] and q_pe [B, H, rope] against the caches ``[B, S, r]`` and
    ``[B, S, rope]`` holding positions ``0..pos``; keys ``kpos <= pos`` count,
    as the reference's masked einsum (one stripe). The H query heads share
    one KV head: the key is the ``r + rope``-wide latent row, the value its
    first ``r`` columns (a view, read in place). Returns ctx_lat [B, H, r].

    The reference scales these scores by ``(r + rope) ** -0.5``: exactly
    ``Dqk ** -0.5`` of this launch, as prefill's ``(nope + rope) ** -0.5`` is
    of its own launch, so both of MLA's scales are the kernel's one rule."""
    r = ckv_cache.shape[-1]
    k = latent_buffer(ckv_cache, kpe_cache)[:, None]  # [B, 1, S, r + rope]
    q = torch.cat([q_lat, q_pe], -1)[:, :, None]  # [B, H, 1, r + rope]
    out = flash_attention(q, k, k[..., :r], causal=True, q_offset=pos)
    return out[:, :, 0]
