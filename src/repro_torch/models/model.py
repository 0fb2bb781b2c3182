"""Model assembly: embed -> layers -> final norm -> head, on one card or on a
device mesh.

The reference keeps its ``prefix`` layers' parameters one dict a layer and
stacks its blocks' on a leading ``n_blocks`` axis, walked with ``lax.scan``;
the port keeps one parameter dict per layer (``params["layers"]``, in
``cfg.layers()`` order, the prefix first, each with the reference's key
names) and walks them with a loop. ``repro_torch.convert.
lm_params_from_arrays`` unstacks the reference's pytree into this layout.
Each layer's leaves come from ``init_layer`` (the per-module ``init_*``
functions, drawn in one fixed order), its sharding specs from
``specs_layer``, and its full-sequence step is ``apply_layer``, as in the
reference. ``param_specs``/``cache_specs`` follow the port's flat layout;
``convert.stack_layers`` maps them to the reference's (a stacked leaf's
spec gains a leading ``None``).

On a mesh (``Model(cfg, device, ax=, mesh=)``, a ``torch.distributed``
``DeviceMesh``) the parameters are DTensors placed by ``param_specs``
(``launch.mesh.shard_tree``) and the inputs DTensors split over the data
axes. Each rank computes on plain tensors on ``device``: its batch rows,
with each layer's weights gathered whole for the layer (the reference's
``"d"`` convention, FSDP on d_model gathered per layer). A gathered
weight's gradient is read as ``Partial`` over the axes that split the batch
and ``Replicate`` over the others (``launch.mesh.batch_grad_placements``),
so that the shards' gradients are summed once. A decode step gathers each
layer's cache over the model axis (the reference shards its sequence
there), steps it, and keeps its own shard. Expert weights placed by
``specs_moe_fshard`` (``moe_weight_shard="f"``) are never gathered:
``moe_ffn_fshard`` uses them where they lie.

``activation_partitioning="seq"`` on a model axis larger than 1 splits each
rank's rows along the sequence too (the reference's sequence-parallel
mode): a rank holds ``[B_local, T_r, D]``, its stripe of the positions
(``launch.mesh.Stripe``; any T, stripes uneven or empty by DTensor's
``Shard`` rule). Norms, projections, the dense FFN and the head run on the
stripe; attention keeps its query stripe, gathers K and V over the model
axis and runs one launch at ``q_offset`` = the stripe's start; a Mamba
mixer and a MoE FFN gather their normed input over the model axis, run on
the whole sequence (so a data shard's tokens are scanned and routed whole,
as in ``"batch"``) and keep their stripe of the output. The model axis then
splits the tokens, so a gathered weight's gradient is ``Partial`` over it
as well as over the data axes. The values are ``"batch"``'s; on a model
axis of 1 the two modes are one, as in the reference.

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
from repro_torch.launch.mesh import (
    P,
    Stripe,
    batch_grad_placements,
    gather,
    gather_tree,
    local_slice,
)
from repro_torch.models.attention import (
    gqa_cross_decode,
    gqa_flash_decode,
    gqa_forward,
    init_attention,
    mla_flash_decode,
    mla_forward,
    specs_attention,
)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (
    EXPERT_WEIGHTS,
    Axes,
    Init,
    apply_rope,
    dense_ffn,
    init_dense_ffn,
    init_moe,
    init_rmsnorm,
    moe_ffn,
    moe_ffn_fshard,
    qk_head_norm,
    rms_norm,
    specs_dense_ffn,
    specs_moe,
    specs_moe_fshard,
    specs_rmsnorm,
)
from repro_torch.models.mamba import init_mamba, mamba_decode_step, mamba_forward, specs_mamba


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


def check_partitioning(cfg: ModelConfig) -> None:
    """Raise for an ``activation_partitioning`` the model does not know."""
    if cfg.activation_partitioning not in ("batch", "seq"):
        raise ValueError(f"unknown activation_partitioning {cfg.activation_partitioning!r}")


# ----------------------------------------------------------------- layer p/s
def init_layer(init: Init, spec: LayerSpec, cfg: ModelConfig) -> dict:
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_model
    p: dict = {"norm1": init_rmsnorm(init, d, dt)}
    if spec.mixer == "attn":
        p["attn"] = init_attention(init, cfg, dt)
    elif spec.mixer == "cross_attn":
        p["attn"] = init_attention(init, cfg, dt, cross=True)
    elif spec.mixer == "mamba":
        p["mamba"] = init_mamba(init, cfg, dt)
    if spec.ffn != "none":
        p["norm2"] = init_rmsnorm(init, d, dt)
    if spec.ffn in ("dense", "moe_dense"):
        p["ffn"] = init_dense_ffn(init, d, cfg.d_ff, cfg.activation, dt)
    if spec.ffn in ("moe", "moe_dense"):
        p["moe"] = init_moe(init, d, cfg.d_ff_expert or cfg.d_ff, cfg.n_experts,
                            cfg.n_shared_experts, cfg.activation, dt)
    return p


def specs_layer(spec: LayerSpec, cfg: ModelConfig, ax: Axes) -> dict:
    p: dict = {"norm1": specs_rmsnorm()}
    if spec.mixer in ("attn", "cross_attn"):
        p["attn"] = specs_attention(cfg, ax, cross=(spec.mixer == "cross_attn"))
    elif spec.mixer == "mamba":
        p["mamba"] = specs_mamba(ax)
    if spec.ffn != "none":
        p["norm2"] = specs_rmsnorm()
    if spec.ffn in ("dense", "moe_dense"):
        p["ffn"] = specs_dense_ffn(ax, cfg.activation, cfg.dense_weight_shard)
    if spec.ffn in ("moe", "moe_dense"):
        specs_fn = specs_moe_fshard if cfg.moe_weight_shard == "f" else specs_moe
        p["moe"] = specs_fn(ax, cfg.activation, cfg.n_shared_experts)
    return p


def _ffn(x: torch.Tensor, p: dict, spec: LayerSpec, cfg: ModelConfig, ax: Axes | None = None,
         mesh=None, batch_axes: tuple = (), stripe: Stripe | None = None):
    """The layer's FFN residual: ``(x + out, aux)``, ``out`` the dense FFN,
    the MoE, or their sum (in that order), on one normed input. With a
    ``stripe`` the MoE routes the whole sequence (gathered) and keeps its
    stripe of the output."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "none":
        return x, aux
    h = rms_norm(x, p["norm2"])
    out = None
    if spec.ffn in ("dense", "moe_dense"):
        out = dense_ffn(h, p["ffn"], cfg.activation)
    if spec.ffn in ("moe", "moe_dense"):
        hm = h if stripe is None else stripe.gather(h)
        if cfg.moe_weight_shard == "f":
            mo, aux = moe_ffn_fshard(hm, p["moe"], cfg, ax, mesh, batch_axes,
                                     seq_parallel=stripe is not None)
        else:
            mo, aux = moe_ffn(hm, p["moe"], cfg,
                              name_output=cfg.remat and cfg.remat_policy == "save_moe")
        if stripe is not None:
            mo = stripe.keep(mo)
        out = mo if out is None else out + mo
    return x + out, aux


def apply_layer(x: torch.Tensor, p: dict, spec: LayerSpec, cfg: ModelConfig,
                ax: Axes | None = None, mesh=None, img_embeds=None, batch_axes: tuple = (),
                stripe: Stripe | None = None):
    """One layer of the full-sequence forward on plain tensors (a rank's
    batch rows, or with ``stripe`` their stripe of the sequence, and the
    layer's weights; expert weights under ``moe_weight_shard="f"`` stay
    DTensors). Returns ``(x, aux, cache)``: the router loss of its MoE
    (zero without one) and the cache entry its mixer made (``(k, v)``, the
    MLA latent or the Mamba states; whole over the sequence). A Mamba mixer
    scans the whole sequence (its input gathered) and keeps its stripe."""
    h = rms_norm(x, p["norm1"])
    if spec.mixer == "attn" and cfg.use_mla:
        y, cache = mla_forward(h, p["attn"], cfg, window=spec.window, stripe=stripe)
    elif spec.mixer == "attn":
        y, cache = gqa_forward(h, p["attn"], cfg, window=spec.window, stripe=stripe)
    elif spec.mixer == "cross_attn":
        y, cache = gqa_forward(h, p["attn"], cfg, window=None, kv_x=img_embeds, stripe=stripe)
    elif stripe is None:
        y, cache = mamba_forward(h, p["mamba"], cfg)
    else:
        y, cache = mamba_forward(stripe.gather(h), p["mamba"], cfg)
        y = stripe.keep(y)
    x, aux = _ffn(x + y, p, spec, cfg, ax, mesh, batch_axes, stripe)
    return x, aux, cache


class Model(nn.Module):
    """The LM of ``cfg`` on ``device`` (default ``"cuda"``; without a card
    only ``device="cpu"`` runs, on the kernels' plain versions), on one
    device or, with ``mesh``, on a rank of a device mesh (``ax`` its data
    and model axes). Parameters live in the dict ``init`` returns and are
    passed to every call, as in the reference."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None,
                 ax: Axes | None = None, mesh=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.ax = ax or Axes()
        self.mesh = mesh
        check_partitioning(cfg)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict:
        """Seeded random parameters on the model's device, at the
        reference's shapes and scales (``generator`` lives on that device),
        whole on every rank (``launch.mesh.shard_tree`` places them on a
        mesh). The numbers differ from the reference's ``jax.random`` ones;
        carry those over with ``lm_params_from_arrays`` to compare the
        packages."""
        return self._init(Init(generator, self.device))

    def init_shapes(self) -> dict:
        """``init``'s tree as empty ``meta`` tensors: the shapes and dtypes,
        nothing drawn, nothing allocated."""
        return self._init(Init.shapes())

    def _init(self, init: Init) -> dict:
        cfg, dt = self.cfg, self.dtype
        d = cfg.d_model
        params: dict = {}
        if cfg.frontend != "frames":  # frame embeddings arrive at d_model width
            params["embed"] = init.normal((cfg.vocab_size, d), 0.02, dt)
        params["layers"] = [init_layer(init, spec, cfg) for spec in cfg.layers()]
        params["final_norm"] = init_rmsnorm(init, d, dt)
        if not cfg.tie_embeddings:
            params["unembed"] = init.normal((d, cfg.vocab_size), d**-0.5, dt)
        return params

    # ----------------------------------------------------------------- specs
    def param_specs(self) -> dict:
        """The sharding spec of every parameter, in ``init``'s layout."""
        cfg, ax = self.cfg, self.ax
        specs: dict = {}
        if cfg.frontend != "frames":
            specs["embed"] = P(ax.tp, ax.dp)  # vocab x d_model
        specs["layers"] = [specs_layer(spec, cfg, ax) for spec in cfg.layers()]
        specs["final_norm"] = specs_rmsnorm()
        if not cfg.tie_embeddings:
            specs["unembed"] = P(ax.dp, ax.tp)
        return specs

    def cache_specs(self) -> list:
        """The sharding spec of every decode-cache leaf, in ``init_cache``'s
        layout: the batch over the data axes; a full-attention (or MLA)
        cache's sequence over the model axis, a ring's replicated; a Mamba
        state's inner width over the model axis."""
        ax = self.ax

        def layer_spec(spec: LayerSpec) -> dict:
            if spec.mixer == "attn":
                seq = None if spec.window is not None else ax.tp
                if self.cfg.use_mla:
                    return {"ckv": P(ax.dp, seq, None), "kpe": P(ax.dp, seq, None)}
                return {"k": P(ax.dp, seq, None, None), "v": P(ax.dp, seq, None, None)}
            if spec.mixer == "cross_attn":
                return {"k_img": P(ax.dp, None, None, None), "v_img": P(ax.dp, None, None, None)}
            return {"conv": P(ax.dp, None, ax.tp), "ssm": P(ax.dp, ax.tp, None)}

        return [layer_spec(spec) for spec in self.cfg.layers()]

    # ---------------------------------------------------------- mesh helpers
    def seq_stripe(self, total: int) -> Stripe | None:
        """This rank's stripe of a ``total``-long sequence where
        ``activation_partitioning="seq"`` splits it over a model axis larger
        than 1, else ``None``."""
        if self.cfg.activation_partitioning != "seq" or self.mesh is None \
                or self.mesh.size(self.mesh.mesh_dim_names.index(self.ax.tp)) == 1:
            return None
        return Stripe.of(self.mesh, self.ax.tp, total)

    def token_split(self, batch: dict, rows_dim: int = 0) -> tuple:
        """``(mesh, mesh dims, stripe)`` for a batch of this model: the mesh
        dims that split its tokens (those that shard the batch rows, dim
        ``rows_dim`` of the tokens' or frames' DTensor: 1 under a leading
        microbatch axis; then the model axis where :meth:`seq_stripe` splits
        the sequence over it), and this rank's stripe (``None`` without a
        split); ``(None, (), None)`` for plain tensors unsplit."""
        from torch.distributed.tensor import DTensor, Shard

        t = batch.get("tokens", batch.get("frames"))
        stripe = self.seq_stripe(t.shape[rows_dim + 1])
        mesh, dims = None, ()
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            dims = tuple(i for i, pl in enumerate(t.placements)
                         if isinstance(pl, Shard) and pl.dim == rows_dim)
        if stripe is not None:
            mesh = self.mesh
            dims += (self.mesh.mesh_dim_names.index(self.ax.tp),)
        return mesh, dims, stripe

    def _local(self, inputs: dict, split_seq: bool = True) -> tuple[dict, tuple, Stripe | None]:
        """Plain tensors on the model's device for ``inputs`` (DTensors split
        over the data axes, or plain tensors), the mesh axes that split
        their batch, and with ``split_seq`` the rank's stripe of the
        sequence (:meth:`seq_stripe`; the tokens or frames are cut to it on
        dim 1)."""
        from torch.distributed.tensor import DTensor, Shard

        batch_axes: tuple = ()
        out = {}
        for name, t in inputs.items():
            if isinstance(t, DTensor):
                axes = tuple(n for n, pl in zip(t.device_mesh.mesh_dim_names, t.placements)
                             if isinstance(pl, Shard) and pl.dim == 0)
                if name in ("tokens", "frames"):
                    batch_axes = axes
                t = t.to_local()
            out[name] = t.to(self.device) if t.device != self.device else t
        seq = "tokens" if "tokens" in out else "frames"
        stripe = self.seq_stripe(out[seq].shape[1]) if split_seq and seq in out else None
        if stripe is not None:
            out[seq] = stripe.keep(out[seq])
        return out, batch_axes, stripe

    def _weights(self, tree, batch_axes: tuple, spec: LayerSpec | None = None):
        """``tree``'s weights gathered whole on the model's device (on a
        mesh), their gradients read as the batch split over ``batch_axes``;
        the expert weights of a ``moe_weight_shard="f"`` layer stay put."""
        if self.mesh is None:
            return tree
        gp = batch_grad_placements(self.mesh, batch_axes)
        if spec is not None and "moe" in tree and self.cfg.moe_weight_shard == "f":
            moe = {k: (v if k in EXPERT_WEIGHTS else gather_tree(v, gp, self.device))
                   for k, v in tree["moe"].items()}
            rest = gather_tree({k: v for k, v in tree.items() if k != "moe"}, gp, self.device)
            return {**rest, "moe": moe}
        return gather_tree(tree, gp, self.device)

    # --------------------------------------------------------------- forward
    def _embed(self, params: dict, tokens: torch.Tensor, batch_axes: tuple = ()) -> torch.Tensor:
        x = self._weights(params["embed"], batch_axes)[tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        return x

    def _head(self, params: dict, x: torch.Tensor, batch_axes: tuple = ()) -> torch.Tensor:
        x = rms_norm(x, self._weights(params["final_norm"], batch_axes))
        if self.cfg.tie_embeddings:
            return x @ self._weights(params["embed"], batch_axes).T
        return x @ self._weights(params["unembed"], batch_axes)

    def forward(self, params: dict, inputs: dict):
        """Full-sequence forward. inputs: ``{"tokens": [B, S]}`` (or
        ``{"frames": [B, S, D]}``, cast to the model's dtype) and optionally
        ``"image_embeds"`` [B, N, D], the source of every cross-attention
        layer (without it such a layer attends to its own input, as the
        reference's does). Returns ``(logits [B, S, V], aux_loss)``;
        ``aux_loss`` is the MoE router loss summed over the layers (float32;
        zero without MoE layers). On a mesh the inputs are DTensors (or this
        rank's rows) and the logits are this rank's rows, under
        ``activation_partitioning="seq"`` their stripe of the positions
        (:meth:`seq_stripe`). Every rank of a sequence split gets the same
        ``aux``."""
        cfg = self.cfg
        inputs, batch_axes, stripe = self._local(inputs)
        # the axes that split the tokens: a gathered weight's gradient is a
        # part of the sum over them
        grad_axes = batch_axes + ((self.ax.tp,) if stripe is not None else ())
        if cfg.frontend == "frames":
            x = inputs["frames"].to(self.dtype)
        else:
            x = self._embed(params, inputs["tokens"], grad_axes)
        img = inputs.get("image_embeds")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, p in zip(cfg.layers(), params["layers"]):
            p = self._weights(p, grad_axes, spec)
            if cfg.remat and _needs_grad(x, p):
                context = checkpoint.noop_context_fn
                if cfg.remat_policy in _POLICIES:
                    context = functools.partial(
                        checkpoint.create_selective_checkpoint_contexts,
                        _POLICIES[cfg.remat_policy])
                x, a = checkpoint.checkpoint(self._layer, x, p, spec, img, batch_axes, stripe,
                                             use_reentrant=False, context_fn=context)
            else:
                x, a = self._layer(x, p, spec, img, batch_axes, stripe)
            aux = aux + a
        return self._head(params, x, grad_axes), aux

    def _ffn(self, x: torch.Tensor, p: dict, spec: LayerSpec, batch_axes: tuple = ()):
        """The layer's FFN residual: ``(x + out, aux)`` (:func:`_ffn`)."""
        return _ffn(x, p, spec, self.cfg, self.ax, self.mesh, batch_axes)

    def _layer(self, x: torch.Tensor, p: dict, spec: LayerSpec, img=None, batch_axes: tuple = (),
               stripe: Stripe | None = None):
        """One layer of the full-sequence forward: ``(x, aux)``; ``img`` the
        image embeddings a cross-attention layer reads."""
        x, aux, _ = apply_layer(x, p, spec, self.cfg, self.ax, self.mesh, img, batch_axes,
                                stripe)
        return x, aux

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

    def _decode_layer(self, x, p, spec: LayerSpec, cache: dict, pos: int,
                      batch_axes: tuple = ()):
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
        x, _ = self._ffn(x, p, spec, batch_axes)  # the router loss of a decode step is dropped
        return x

    def _cache_in(self, cache: dict) -> dict:
        """A layer's cache on the model's device: this rank's batch rows,
        whole over every other axis (an all-gather over the model axis where
        the spec shards it). An MLA layer's two leaves become views of one
        buffer again, which the absorbed decode reads in one launch."""
        from torch.distributed.tensor import Replicate

        out = {}
        for name, t in cache.items():
            keep = tuple(pl if n in self.ax.dp else Replicate()
                         for n, pl in zip(self.mesh.mesh_dim_names, t.placements))
            out[name] = t.redistribute(self.mesh, keep).to_local().to(self.device)
        if "ckv" in out:
            r = out["ckv"].shape[-1]
            latent = torch.cat([out["ckv"], out["kpe"]], dim=-1)
            out = {"ckv": latent[..., :r], "kpe": latent[..., r:]}
        return out

    def _cache_out(self, cache: dict, stepped: dict) -> None:
        """Each leaf of ``cache`` (DTensors) replaced by this rank's shard of
        the stepped whole layer cache (a slice, no communication)."""
        from torch.distributed.tensor import DTensor, Replicate

        for name, t in cache.items():
            split = tuple(Replicate() if n in self.ax.dp else pl
                          for n, pl in zip(self.mesh.mesh_dim_names, t.placements))
            local = local_slice(stepped[name], split, self.mesh).contiguous()
            cache[name] = DTensor.from_local(local.to(t.device), self.mesh, t.placements,
                                             run_check=False, shape=t.shape, stride=t.stride())

    def decode_step(self, params: dict, cache: list, tokens: torch.Tensor, pos: int):
        """One decode step. tokens: [B, 1]; ``pos`` the position being
        written. Returns ``(logits [B, 1, V], cache)``, the cache updated in
        place. On a mesh ``tokens`` is a DTensor (or this rank's rows), the
        cache a list of dicts of DTensors placed by ``cache_specs``, and the
        logits are this rank's rows."""
        if self.cfg.is_encoder_only:
            raise ValueError(f"{self.cfg.name} is encoder-only: it has no decode path")
        inputs, batch_axes, _ = self._local({"tokens": tokens}, split_seq=False)
        x = self._embed(params, inputs["tokens"], batch_axes)
        for spec, p, c in zip(self.cfg.layers(), params["layers"], cache):
            p = self._weights(p, batch_axes, spec)
            if self.mesh is None:
                x = self._decode_layer(x, p, spec, c, pos, batch_axes)
                continue
            stepped = self._cache_in(c)
            x = self._decode_layer(x, p, spec, stepped, pos, batch_axes)
            self._cache_out(c, stepped)
        return self._head(params, x, batch_axes), cache
