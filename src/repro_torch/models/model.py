"""Model assembly: embed -> layers -> final norm -> head, for one card.

The reference keeps its ``prefix`` layers' parameters one dict a layer and
stacks its blocks' on a leading ``n_blocks`` axis, walked with ``lax.scan``;
the port keeps one parameter dict per layer (``params["layers"]``, in
``cfg.layers()`` order, the prefix first, each with the reference's key
names) and walks them with a loop. ``repro_torch.convert.
lm_params_from_arrays`` unstacks the reference's pytree into this layout.

The decode cache is a list with one dict per layer; ``decode_step`` writes
it in place (the reference returns a new pytree) and returns it.

``forward`` is differentiable, as the reference's is: the attention and scan
kernels carry the plain versions' gradients (their wrappers' autograd
Functions). With ``cfg.remat`` each layer that takes part in a backward
runs under ``torch.utils.checkpoint`` (non-reentrant), with a policy per
``remat_policy``: ``"dots"`` keeps the matmul outputs (the reference's
``dots_with_no_batch_dims_saveable``: ``aten.mm``/``addmm``, not the
batched attention or expert products), ``"nothing"`` keeps none, and
``"save_moe"`` keeps only the routed MoE output of each MoE layer (the
reference's ``save_only_these_names("moe_out")``; torch has no names, so
that output passes through the identity operator
``repro_torch::moe_out``, and the policy keeps that operator's result and
recomputes everything else, the expert products included). The reference
checkpoints a whole block of its scan, the port each layer; recomputation
replays the same operations, so the gradients are the same either way, and
equal to those with remat off.

The forward returns the router aux loss summed over the MoE layers in
layer order, as the reference's scan carry does. An arctic-style
``"moe_dense"`` FFN adds the dense FFN and the MoE on the same normed input
into one residual (``x + (dense + moe)``, the reference's order).

Supported: token inputs and precomputed frame inputs (``frontend ==
"frames"``: ``inputs["frames"]`` [B, S, D] in place of the embedding, no
``embed`` parameter; an encoder-only model has no decode path), GQA
self-attention (qk-norm, full attention and sliding windows, causal or
bidirectional), gated cross-attention layers over ``inputs["image_embeds"]``
[B, N, D], MLA (deepseek-v2-236b: the expanded form in the forward, the
absorbed form in the decode step), Mamba-1 mixers, dense, MoE and dense +
MoE FFNs, and ``prefix`` layers of any of them before the blocks.

Decode caches as in the reference: a sliding-window layer keeps a ring of
``min(seq, window)`` slots (position ``pos`` in slot ``pos % window`` once
the cache is a whole window long, keys RoPE'd as they are written); a
cross-attention layer keeps the image's keys and values ``k_img``/``v_img``
[B, n_img_tokens, Hkv, Dh], which the caller fills (``img @ wk``, ``img @
wv``, as the reference's tests do; ``init_cache`` gives zeros, as the
reference's serve loop uses them); an MLA layer keeps the compressed latent
``ckv`` [B, L, kv_lora_rank] and the RoPE'd key ``kpe`` [B, L, qk_rope_dim],
here two views of one ``[B, L, kv_lora_rank + qk_rope_dim]`` buffer, which
the absorbed decode reads in one launch with no copy.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint as checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    gqa_cross_decode,
    gqa_flash_decode,
    gqa_forward,
    mla_flash_decode,
    mla_forward,
)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import apply_rope, dense_ffn, moe_ffn, qk_head_norm, rms_norm
from repro_torch.models.mamba import mamba_decode_step, mamba_forward


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.frontend not in ("tokens", "frames"):
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")
    for spec in cfg.layers():
        if spec.mixer not in ("attn", "cross_attn", "mamba"):
            raise ValueError(f"{cfg.name}: unknown mixer {spec.mixer!r}")
        if spec.ffn not in ("dense", "moe", "moe_dense", "none"):
            raise ValueError(f"{cfg.name}: unknown FFN {spec.ffn!r}")
    if cfg.remat and cfg.remat_policy not in ("dots", "nothing", "save_moe"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


# the matmuls whose outputs remat_policy "dots" keeps: products with no
# batch dimension, as the reference's dots_with_no_batch_dims_saveable
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _saving(ops: tuple):
    """A selective-checkpoint policy that keeps the outputs of ``ops``."""

    def policy(ctx, op, *args, **kwargs):
        if op in ops:
            return checkpoint.CheckpointPolicy.MUST_SAVE
        return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE

    return policy


_POLICIES = {"dots": _saving(_SAVED_DOTS),
             "save_moe": _saving((torch.ops.repro_torch.moe_out.default,))}


def _needs_grad(x: torch.Tensor, p: dict) -> bool:
    if not torch.is_grad_enabled():
        return False
    stack = [x, p]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif t.requires_grad:
            return True
    return False


class Model(nn.Module):
    """The LM of ``cfg`` on ``device`` (default ``"cuda"``; without a card
    only ``device="cpu"`` runs, on the kernels' plain versions). Parameters
    live in the dict ``init`` returns and are passed to every call, as in the
    reference."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict:
        """Seeded random parameters on the model's device, at the
        reference's shapes and scales (``generator`` lives on that device).
        The numbers differ from the reference's ``jax.random`` ones; carry
        those over with ``lm_params_from_arrays`` to compare the packages."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        d = cfg.d_model

        def normal(shape, scale, dtype=dt):
            return torch.randn(shape, generator=generator, device=dev, dtype=dtype).mul_(scale)

        def ones(n, dtype=dt):
            return torch.ones(n, dtype=dtype, device=dev)

        def zeros(n, dtype=dt):
            return torch.zeros(n, dtype=dtype, device=dev)

        def dense(f: int) -> dict:
            p = {"w_in": normal((d, f), d**-0.5), "w_out": normal((f, d), f**-0.5)}
            if cfg.activation == "swiglu":
                p["w_gate"] = normal((d, f), d**-0.5)
            return p

        def mla() -> dict:
            h, r, qr = cfg.n_heads, cfg.kv_lora_rank, cfg.q_lora_rank
            nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            s = d**-0.5
            p = {
                "wkv_a": normal((d, r + rope_d), s),
                "kv_norm": ones(r),
                "wkv_b": normal((r, h * (nope + vd)), r**-0.5),
                "wo": normal((h * vd, d), (h * vd) ** -0.5),
            }
            if qr:
                p["wq_a"] = normal((d, qr), s)
                p["q_norm"] = ones(qr)
                p["wq_b"] = normal((qr, h * (nope + rope_d)), qr**-0.5)
            else:
                p["wq"] = normal((d, h * (nope + rope_d)), s)
            return p

        def layer(spec: LayerSpec) -> dict:
            p: dict = {"norm1": {"scale": ones(d)}}
            if spec.mixer == "attn" and cfg.use_mla:
                p["attn"] = mla()
            elif spec.mixer in ("attn", "cross_attn"):
                h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
                s = d**-0.5
                p["attn"] = {
                    "wq": normal((d, h * dh), s),
                    "wk": normal((d, hkv * dh), s),
                    "wv": normal((d, hkv * dh), s),
                    "wo": normal((h * dh, d), (h * dh) ** -0.5),
                }
                if cfg.qk_norm:
                    p["attn"]["q_scale"] = ones(dh)
                    p["attn"]["k_scale"] = ones(dh)
                if spec.mixer == "cross_attn" and cfg.cross_attn_gated:
                    p["attn"]["gate"] = zeros(1)  # tanh(0): the image path starts closed
            else:  # mamba
                di, n = cfg.mamba_expand * d, cfg.ssm_state
                dt_rank = max(d // 16, 1)
                p["mamba"] = {
                    "in_proj": normal((d, 2 * di), d**-0.5),
                    "conv_w": normal((cfg.d_conv, di), 0.1),
                    "conv_b": zeros(di),
                    "x_proj": normal((di, dt_rank + 2 * n), di**-0.5),
                    "dt_proj": normal((dt_rank, di), dt_rank**-0.5),
                    "dt_bias": zeros(di, torch.float32),
                    "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
                    .expand(di, n).contiguous(),
                    "d_skip": ones(di, torch.float32),
                    "out_proj": normal((di, d), di**-0.5),
                }
            if spec.ffn != "none":
                p["norm2"] = {"scale": ones(d)}
            if spec.ffn in ("dense", "moe_dense"):
                p["ffn"] = dense(cfg.d_ff)
            if spec.ffn in ("moe", "moe_dense"):
                e, f = cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
                p["moe"] = {  # the router stays float32 in a bf16 model
                    "router": normal((d, e), d**-0.5, torch.float32),
                    "w_in": normal((e, d, f), d**-0.5),
                    "w_out": normal((e, f, d), f**-0.5),
                }
                if cfg.activation == "swiglu":
                    p["moe"]["w_gate"] = normal((e, d, f), d**-0.5)
                if cfg.n_shared_experts:
                    p["moe"]["shared"] = dense(cfg.n_shared_experts * f)
            return p

        params: dict = {}
        if cfg.frontend != "frames":  # frame embeddings arrive at d_model width
            params["embed"] = normal((cfg.vocab_size, d), 0.02)
        params["layers"] = [layer(spec) for spec in cfg.layers()]
        params["final_norm"] = {"scale": ones(d)}
        if not cfg.tie_embeddings:
            params["unembed"] = normal((d, cfg.vocab_size), d**-0.5)
        return params

    # --------------------------------------------------------------- forward
    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        return x

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"])
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["unembed"]

    def forward(self, params: dict, inputs: dict):
        """Full-sequence forward. inputs: ``{"tokens": [B, S]}`` (or
        ``{"frames": [B, S, D]}``, cast to the model's dtype) and optionally
        ``"image_embeds"`` [B, N, D], the source of every cross-attention
        layer (without it such a layer attends to its own input, as the
        reference's does). Returns ``(logits [B, S, V], aux_loss)``;
        ``aux_loss`` is the MoE router loss summed over the layers (float32;
        zero without MoE layers)."""
        cfg = self.cfg
        if cfg.frontend == "frames":
            x = inputs["frames"].to(self.dtype)
        else:
            x = self._embed(params, inputs["tokens"])
        img = inputs.get("image_embeds")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, p in zip(cfg.layers(), params["layers"]):
            if cfg.remat and _needs_grad(x, p):
                context = checkpoint.noop_context_fn
                if cfg.remat_policy in _POLICIES:
                    context = functools.partial(
                        checkpoint.create_selective_checkpoint_contexts,
                        _POLICIES[cfg.remat_policy])
                x, a = checkpoint.checkpoint(self._layer, x, p, spec, img, use_reentrant=False,
                                             context_fn=context)
            else:
                x, a = self._layer(x, p, spec, img)
            aux = aux + a
        return self._head(params, x), aux

    def _ffn(self, x: torch.Tensor, p: dict, spec: LayerSpec):
        """The layer's FFN residual: ``(x + out, aux)``, ``out`` the dense
        FFN, the MoE, or their sum (in that order), on one normed input."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if spec.ffn == "none":
            return x, aux
        h = rms_norm(x, p["norm2"])
        out = None
        if spec.ffn in ("dense", "moe_dense"):
            out = dense_ffn(h, p["ffn"], cfg.activation)
        if spec.ffn in ("moe", "moe_dense"):
            mo, aux = moe_ffn(h, p["moe"], cfg,
                              name_output=cfg.remat and cfg.remat_policy == "save_moe")
            out = mo if out is None else out + mo
        return x + out, aux

    def _layer(self, x: torch.Tensor, p: dict, spec: LayerSpec, img=None):
        """One layer of the full-sequence forward: ``(x, aux)``; ``img`` the
        image embeddings a cross-attention layer reads."""
        cfg = self.cfg
        h = rms_norm(x, p["norm1"])
        if spec.mixer == "attn" and cfg.use_mla:
            y, _ = mla_forward(h, p["attn"], cfg, window=spec.window)
        elif spec.mixer == "attn":
            y, _ = gqa_forward(h, p["attn"], cfg, window=spec.window)
        elif spec.mixer == "cross_attn":
            y, _ = gqa_forward(h, p["attn"], cfg, window=None, kv_x=img)
        else:
            y, _ = mamba_forward(h, p["mamba"], cfg)
        return self._ffn(x + y, p, spec)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, seq: int, dtype: torch.dtype | None = None) -> list:
        """One dict per layer: ``{"k", "v"}`` ``[B, L, Hkv, Dh]`` for
        attention (``L = seq``, or ``min(seq, window)`` for a sliding-window
        layer: a ring once ``seq >= window``), ``{"ckv" [B, L, r], "kpe"
        [B, L, rope]}`` for MLA (views of one ``[B, L, r + rope]`` buffer),
        ``{"k_img", "v_img"}`` ``[B, n_img_tokens, Hkv, Dh]`` for
        cross-attention (zeros until the caller writes the image's keys and
        values), ``{"conv" [B, d_conv-1, di], "ssm" [B, di, N] float32}``
        for Mamba."""
        cfg, dev = self.cfg, self.device
        dt = dtype or self.dtype
        di = cfg.mamba_expand * cfg.d_model
        cache = []
        for spec in cfg.layers():
            if spec.mixer == "attn" and cfg.use_mla:
                length = seq if spec.window is None else min(seq, spec.window)
                r = cfg.kv_lora_rank
                latent = torch.zeros((batch, length, r + cfg.qk_rope_dim), dtype=dt, device=dev)
                cache.append({"ckv": latent[..., :r], "kpe": latent[..., r:]})
            elif spec.mixer in ("attn", "cross_attn"):
                if spec.mixer == "cross_attn":
                    names, length = ("k_img", "v_img"), cfg.n_img_tokens
                else:
                    names = ("k", "v")
                    length = seq if spec.window is None else min(seq, spec.window)
                shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
                cache.append({n: torch.zeros(shape, dtype=dt, device=dev) for n in names})
            else:
                cache.append({
                    "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dt, device=dev),
                    "ssm": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                                       device=dev),
                })
        return cache

    # ---------------------------------------------------------------- decode
    def _decode_gqa(self, x, h, p, cache: dict, pos: int, spec: LayerSpec):
        cfg = self.cfg
        b = x.shape[0]
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (h @ p["wq"]).reshape(b, 1, hq, dh)
        k = (h @ p["wk"]).reshape(b, 1, hkv, dh)
        v = (h @ p["wv"]).reshape(b, 1, hkv, dh)
        if cfg.qk_norm:
            q = qk_head_norm(q, p["q_scale"])
            k = qk_head_norm(k, p["k_scale"])
        posv = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
        # the slot is written before attending, as in the reference: a
        # window-long cache is a ring (slot pos % window), a shorter one is
        # written at pos
        length = cache["k"].shape[1]
        ring = spec.window is not None and length == spec.window
        slot = pos % length if ring else pos
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        # The reference attends the ring's slot s where s <= pos or pos >=
        # length: a cold ring the slots written so far, a warm one every
        # slot (RoPE was applied at write time, so slot order does not
        # matter). That is the key set of a causal launch over the ring at
        # q_offset = pos with no window (slot s kept iff s <= pos, which
        # holds for every slot once pos >= length - 1); the kernel sums the
        # slots in slot order, not position order, a float-order difference.
        out = gqa_flash_decode(q[:, 0], cache["k"], cache["v"], pos,
                               None if ring else spec.window)  # [B, H, Dh]
        return x + out.reshape(b, 1, hq * dh) @ p["wo"]

    def _decode_mla(self, x, h, p, cache: dict, pos: int):
        """The absorbed-form MLA step, as the reference's ``_decode_mla``: the
        new latent row (``c_kv``, the RoPE'd ``k_pe``) written at ``pos``,
        ``q_nope`` taken into the latent space by ``w_uk``, one launch over
        the latent cache, the context taken back out by ``w_uv``. The
        absorbed projections are einsums, as the reference computes them
        outside any kernel. They split ``wkv_b``'s columns into a first
        ``H * nope`` (keys) and a last ``H * v_head_dim`` (values), where the
        forward reads it per head (``[nope + v_head_dim]`` a head): the
        reference's own layouts, copied."""
        cfg = self.cfg
        b = x.shape[0]
        nh = cfg.n_heads
        nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        if cfg.q_lora_rank:
            qa = rms_norm(h @ p["wq_a"], {"scale": p["q_norm"]})
            q = (qa @ p["wq_b"]).reshape(b, 1, nh, nope + rope_d)
        else:
            q = (h @ p["wq"]).reshape(b, 1, nh, nope + rope_d)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        posv = torch.full((b, 1), pos, device=x.device)
        q_pe = apply_rope(q_pe, posv, cfg.rope_theta)
        kv_a = h @ p["wkv_a"]  # [B, 1, r + rope]
        c_kv = rms_norm(kv_a[..., :r], {"scale": p["kv_norm"]})
        k_pe = apply_rope(kv_a[..., None, r:], posv, cfg.rope_theta)[:, :, 0]
        cache["ckv"][:, pos] = c_kv[:, 0].to(cache["ckv"].dtype)
        cache["kpe"][:, pos] = k_pe[:, 0].to(cache["kpe"].dtype)
        w_uk = p["wkv_b"][:, : nh * nope].reshape(r, nh, nope)
        w_uv = p["wkv_b"][:, nh * nope :].reshape(r, nh, vd)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
        ctx_lat = mla_flash_decode(q_lat, q_pe[:, 0], cache["ckv"], cache["kpe"], pos)
        out = torch.einsum("bhr,rhv->bhv", ctx_lat, w_uv)
        return x + out.reshape(b, 1, nh * vd) @ p["wo"]

    def _decode_layer(self, x, p, spec: LayerSpec, cache: dict, pos: int):
        """One-token step for one layer. x: [B, 1, D]; ``cache`` is updated."""
        h = rms_norm(x, p["norm1"])
        if spec.mixer == "attn" and self.cfg.use_mla:
            x = self._decode_mla(x, h, p["attn"], cache, pos)
        elif spec.mixer == "attn":
            x = self._decode_gqa(x, h, p["attn"], cache, pos, spec)
        elif spec.mixer == "cross_attn":
            x = x + gqa_cross_decode(h, p["attn"], self.cfg, cache["k_img"], cache["v_img"])
        else:
            y, (cache["conv"], cache["ssm"]) = mamba_decode_step(
                h, p["mamba"], self.cfg, cache["conv"], cache["ssm"])
            x = x + y
        x, _ = self._ffn(x, p, spec)  # the router loss of a decode step is dropped
        return x

    def decode_step(self, params: dict, cache: list, tokens: torch.Tensor, pos: int):
        """One decode step. tokens: [B, 1]; ``pos`` the position being
        written. Returns ``(logits [B, 1, V], cache)``, the cache updated in
        place."""
        if self.cfg.is_encoder_only:
            raise ValueError(f"{self.cfg.name} is encoder-only: it has no decode path")
        x = self._embed(params, tokens)
        for spec, p, c in zip(self.cfg.layers(), params["layers"], cache):
            x = self._decode_layer(x, p, spec, c, pos)
        return self._head(params, x), cache
