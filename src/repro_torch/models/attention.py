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

Tensor-parallel (``tp``, a ``launch.mesh.ModelAxis``; a model axis above 1
under ``"batch"`` and ``"seq"`` alike): a layer is one region, its input
entering whole over the sequence and its output leaving through the
model axis's sum (``ModelAxis.enter``/``exit``). Where the specs split its
weights over the axis, ``wq`` (MLA: ``wq_b``/``wq`` and ``wkv_b``) is
this rank's column chunk, read as its own query heads (:func:`own_heads`:
the chunk itself where it is whole heads, else the heads the chunk overlaps,
cut from the product all-gathered over the axis), one launch runs those
heads, and ``wo``'s row chunk takes their output (:func:`own_cols`) to a
partial sum. ``wk``/``wv`` chunks need not be whole KV heads (repro-100m's
5 x 64 columns over 2 ranks, 2 KV heads over 4): a rank whose chunk is not
exactly the KV heads its query heads read all-gathers its chunk of K and V
over the axis (``Hkv * Dh`` columns, the reference's "cheap to all-gather")
and takes those heads; the launch's GQA group is its query heads over its
KV heads, which can differ from the model's (:func:`_launch_kv`). MLA's
latent (``wkv_a``, ``wq_a``, replicated) is computed whole on every rank,
as the reference does. Cross-attention's gate applies after the sum.

``init_attention`` and ``specs_attention`` give a layer's parameters and
their sharding specs (the GQA, cross and MLA variants).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.mesh import ModelAxis, P
from repro_torch.models.layers import (
    Axes,
    Init,
    apply_rope,
    qk_head_norm,
    rms_norm,
    row_product,
)


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


def _head_span(cols: int, width: int, tp) -> tuple[int, int, int]:
    """``(h0, h1, offset)``: the heads ``h0 .. h1 - 1`` that this rank's
    column chunk (``cols`` of a product ``width`` columns a head, chunk
    ``tp.rank``) overlaps, and where the chunk starts in their columns."""
    c0 = tp.rank * cols
    h0 = c0 // width
    return h0, -(-(c0 + cols) // width), c0 - h0 * width


def own_heads(y: torch.Tensor, width: int, tp) -> tuple[torch.Tensor, int]:
    """This rank's heads of a column-parallel product ``y`` ``[..., cols]``
    (its chunk of ``n_heads * width`` columns): ``([..., nh, width], h0)``,
    the chunk itself where it is whole heads, else the heads it overlaps,
    cut from ``y`` all-gathered over the model axis (backward: the summed
    gradient reduce-scattered)."""
    cols = y.shape[-1]
    h0, h1, off = _head_span(cols, width, tp)
    if off == 0 and cols % width == 0:
        return y.unflatten(-1, (cols // width, width)), h0
    whole = tp.gather(y, -1)
    return whole[..., h0 * width:h1 * width].unflatten(-1, (h1 - h0, width)), h0


def own_cols(out: torch.Tensor, h0: int, width: int, cols: int, tp) -> torch.Tensor:
    """This rank's column chunk (``cols`` wide, the rows of its ``wo``
    chunk) of ``out`` ``[..., nh * width]``, computed for heads from
    ``h0``."""
    off = tp.rank * cols - h0 * width
    return out if off == 0 and out.shape[-1] == cols else out[..., off:off + cols]


def _kv_heads(k: torch.Tensor, v: torch.Tensor, kv0: int, kv1: int, dh: int, hkv: int, tp):
    """KV heads ``kv0 .. kv1 - 1`` ``[..., nkv, Dh]`` of this rank's ``k``
    and ``v`` products (its column chunks where the specs split ``wk`` and
    ``wv``, else whole): the chunks themselves where they are exactly those
    heads, else cut from K and V all-gathered over the model axis (one
    collective)."""
    ck = k.shape[-1]
    if ck < hkv * dh:
        if tp.rank * ck == kv0 * dh and ck == (kv1 - kv0) * dh:
            return k.unflatten(-1, (kv1 - kv0, dh)), v.unflatten(-1, (kv1 - kv0, dh))
        kv = tp.gather(torch.cat([k, v], -1), -1).unflatten(-1, (tp.size, 2, ck))
        k, v = kv[..., 0, :].flatten(-2), kv[..., 1, :].flatten(-2)
    return (k[..., kv0 * dh:kv1 * dh].unflatten(-1, (kv1 - kv0, dh)),
            v[..., kv0 * dh:kv1 * dh].unflatten(-1, (kv1 - kv0, dh)))


def _launch_kv(k: torch.Tensor, v: torch.Tensor, h0: int, nq: int, g: int, kv0: int,
               head_dim: int = 2):
    """K and V for one launch of query heads ``h0 .. h0 + nq - 1`` (the
    model's group ``g``) over KV heads from ``kv0`` (along ``head_dim``):
    as they are where the kernel's own grouping (query head ``i`` reads KV
    head ``i // (nq / nkv)``) reads the right heads, else one KV head per
    query head (group 1)."""
    nkv = k.shape[head_dim]
    want = [(h0 + i) // g - kv0 for i in range(nq)]
    if nq % nkv == 0 and want == [i // (nq // nkv) for i in range(nq)]:
        return k, v
    idx = torch.tensor(want, device=k.device)
    return k.index_select(head_dim, idx), v.index_select(head_dim, idx)


def gqa_forward(x: torch.Tensor, p: dict, cfg, window: int | None, kv_x=None,
                causal: bool | None = None, tp: ModelAxis = ModelAxis()):
    """Full-sequence attention (prefill). x: [B, T, D] (under ``"seq"``,
    this rank's stripe); ``kv_x`` [B, S, D] the cross-attention source
    (cast to ``x``'s dtype: the kernel takes one dtype). Returns ``(y [B, T,
    D], (k, v))`` with k, v ``[B, S, Hkv, Dh]`` over the whole sequence
    (where ``tp.split``, the KV heads this rank read)."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = tp.enter(x)
    b, t, _ = x.shape
    src = x if kv_x is None else kv_x.to(x.dtype)
    s = src.shape[1]
    q, k, v = x @ p["wq"], src @ p["wk"], src @ p["wv"]
    h0, kv0 = 0, 0
    if tp.split:
        q, h0 = own_heads(q, dh, tp)
        kv0 = h0 // (h // hkv)
        k, v = _kv_heads(k, v, kv0, (h0 + q.shape[2] - 1) // (h // hkv) + 1, dh, hkv, tp)
    else:
        q, k, v = q.reshape(b, t, h, dh), k.reshape(b, s, hkv, dh), v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:  # before RoPE, as qwen3 does
        q = qk_head_norm(q, p["q_scale"])
        k = qk_head_norm(k, p["k_scale"])
    if kv_x is None:  # self-attention gets RoPE
        pos = torch.arange(t, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    nq = q.shape[2]
    kl, vl = _launch_kv(k, v, h0, nq, h // hkv, kv0) if tp.split else (k, v)
    is_causal = (cfg.causal if causal is None else causal) and kv_x is None
    out = flash_attention(q.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
                          causal=is_causal, window=window)
    y = out.transpose(1, 2).reshape(b, t, nq * dh)
    if tp.split:
        y = own_cols(y, h0, dh, p["wo"].shape[0], tp)
    y = tp.exit(row_product(y, p["wo"], tp.split)).to(x.dtype)
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
                     v_img: torch.Tensor, tp: ModelAxis = ModelAxis()) -> torch.Tensor:
    """One decode step of a cross-attention layer (the reference's
    ``_plain_cross_decode``): the query of ``h`` [B, 1, D] (qk-norm, no
    RoPE) over every cached image key ``[B, N, Hkv, Dh]``, one bidirectional
    launch, then ``wo`` and the gate. Where ``tp.split``, this rank's query
    heads over the KV heads they read, ``wo``'s row chunk and the sum.
    Returns ``y`` [B, 1, D]."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = tp.enter(h)
    b = h.shape[0]
    q = h @ p["wq"]
    h0 = 0
    if tp.split:
        q, h0 = own_heads(q, dh, tp)
        g = hq // hkv
        kv0, kv1 = h0 // g, (h0 + q.shape[2] - 1) // g + 1
        k_img, v_img = _launch_kv(k_img[:, :, kv0:kv1], v_img[:, :, kv0:kv1], h0, q.shape[2],
                                  g, kv0)
    else:
        q = q.reshape(b, 1, hq, dh)
    if cfg.qk_norm:
        q = qk_head_norm(q, p["q_scale"])
    out = flash_attention(q.transpose(1, 2), k_img.transpose(1, 2), v_img.transpose(1, 2),
                          causal=False)
    y = out.transpose(1, 2).reshape(b, 1, q.shape[2] * dh)
    if tp.split:
        y = own_cols(y, h0, dh, p["wo"].shape[0], tp)
    return _gated(tp.exit(row_product(y, p["wo"], tp.split)).to(h.dtype), p)


# ----------------------------------------------------------------- MLA paths
def mla_q(x: torch.Tensor, p: dict, cfg, pos: torch.Tensor,
          tp: ModelAxis = ModelAxis()) -> torch.Tensor:
    """MLA's query ``[B, T, H, nope + rope]``, its rope part RoPE'd at ``pos``;
    where ``tp.split`` (``wq_b``/``wq`` split) this rank's heads
    (:func:`own_heads`)."""
    b, t, _ = x.shape
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        qa = rms_norm(x @ p["wq_a"], {"scale": p["q_norm"]})
        q = qa @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = own_heads(q, nope + rope_d, tp)[0] if tp.split \
        else q.reshape(b, t, cfg.n_heads, nope + rope_d)
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


def mla_kv(c_kv: torch.Tensor, k_pe: torch.Tensor, p: dict, cfg, tp: ModelAxis = ModelAxis()):
    """The expanded key ``[B, T, H, nope + rope]`` (the rope part broadcast
    over the heads) and value ``[B, T, H, v_head_dim]`` (a view of the
    ``wkv_b`` product, no copy) of the latent; where ``tp.split``
    (``wkv_b`` split) this rank's heads."""
    b, t, _ = c_kv.shape
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    kv = c_kv @ p["wkv_b"]
    kv = own_heads(kv, nope + cfg.v_head_dim, tp)[0] if tp.split \
        else kv.reshape(b, t, cfg.n_heads, nope + cfg.v_head_dim)
    h = kv.shape[2]
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
                tp: ModelAxis = ModelAxis()):
    """Full-sequence MLA (prefill): one launch at (Dqk, Dv) = (nope + rope,
    v_head_dim), scaled by (nope + rope)^-0.5 as the reference's ``_sdpa``
    scales by its query's width. The reference switches to ``_chunked_sdpa``
    from 8,192 tokens; the kernel covers both. Where ``tp.split`` (``wkv_b``
    split), the latent is computed whole on every rank and the launch runs
    this rank's heads (H / n of them where n divides H). Returns ``(y
    [B, T, D], (c_kv, k_pe))``, the latent over the whole sequence."""
    vd = cfg.v_head_dim
    x = tp.enter(x)
    b, t, _ = x.shape
    pos = torch.arange(t, device=x.device)
    c_kv, k_pe = mla_latent(x, p, cfg, pos)
    k, v = mla_kv(c_kv, k_pe, p, cfg, tp)
    q = mla_q(x, p, cfg, pos, tp)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=cfg.causal, window=window)
    y = out.transpose(1, 2).reshape(b, t, q.shape[2] * vd)
    if tp.split:
        y = own_cols(y, _head_span(p["wo"].shape[0], vd, tp)[0], vd, p["wo"].shape[0], tp)
    return tp.exit(row_product(y, p["wo"], tp.split)).to(x.dtype), (c_kv, k_pe)


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
