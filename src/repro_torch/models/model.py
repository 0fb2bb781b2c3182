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
with each layer's weights gathered over the data axes for the layer (FSDP
on d_model, the reference's ``"d"`` convention). A gathered weight's
gradient is ``Partial`` over the axes that split the batch
(``launch.mesh.batch_grad_placements``), so that the shards' gradients are
summed once.

On a model axis above 1 (``launch.mesh.ModelAxis``) a rank's products are
split over it as the specs place the weights (the reference's GSPMD does
the same): a weight the specs split over the model axis stays split
(``Shard`` there, gathered over the data axes only), and each module is a
tensor-parallel region: column-parallel products on this rank's chunks
(``wq``/``wk``/``wv``, ``wq_b``/``wkv_b``, ``w_in``/``w_gate``,
``in_proj``, ``dt_proj``, the head's vocabulary columns), attention on this
rank's heads and the scan on its channels, row-parallel products (``wo``,
``w_out``, ``out_proj``, ``x_proj``) summed over the axis. A leaf the specs
leave whole but that a split region reads per rank (qk-norm scales, MLA's
latent projections) gets ``Partial`` gradients over the model axis; a
module whose weights the specs leave whole (the ``"d"`` MoE, whose experts
are gathered whole, as the reference's per-rank expert products are
``E x cap`` rows either way; sanitised dims) runs whole on every rank. The
embedding is a masked lookup of this rank's vocabulary rows and a sum; the
forward's logits are this rank's vocabulary columns, which the loss reads
with a vocabulary-parallel log-softmax (``train.step.token_nll``) and the
prefill and decode steps gather. A decode step gathers each attention
layer's cache over the model axis (the reference shards its sequence
there), steps it on this rank's heads, and keeps its own shard; a Mamba
layer's state stays on this rank's channels. Expert weights placed by
``specs_moe_fshard`` (``moe_weight_shard="f"``) are never gathered over the
data axes: ``moe_ffn_fshard`` uses them where they lie.

``activation_partitioning="seq"`` on a model axis larger than 1 splits the
residual stream along the sequence too (Megatron's sequence parallelism): a
rank holds ``[B_local, T_r, D]``, its stripe of the positions
(``launch.mesh.Stripe``; any T, stripes uneven or empty by DTensor's
``Shard`` rule), the norms run on the stripe, and each region gathers the
stripes as it enters and reduce-scatters its partial output back to them as
it exits (a region that is not split keeps its own stripe). A norm's scale,
read on stripes, gets ``Partial`` gradients over the model axis. The values
are ``"batch"``'s; on a model axis of 1 the two modes are one, as in the
reference.

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
    ModelAxis,
    P,
    Stripe,
    batch_grad_placements,
    gather_tree,
    local_slice,
)
from repro_torch.models.attention import (
    _launch_kv,
    gqa_cross_decode,
    gqa_flash_decode,
    gqa_forward,
    init_attention,
    mla_flash_decode,
    mla_forward,
    own_cols,
    own_heads,
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
    row_product,
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
         mesh=None, batch_axes: tuple = (), regions: dict | None = None):
    """The layer's FFN residual: ``(x + out, aux)``, ``out`` the dense FFN,
    the MoE, or their sum (in that order), on one normed input. Each is a
    tensor-parallel region, ``regions["ffn"]`` and ``regions["moe"]`` (a
    ``ModelAxis``; none split where absent). The MoE's is never split: it
    routes the whole sequence on every rank of the model axis."""
    regions = regions or {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "none":
        return x, aux
    h = rms_norm(x, p["norm2"])
    out = None
    if spec.ffn in ("dense", "moe_dense"):
        out = dense_ffn(h, p["ffn"], cfg.activation, regions.get("ffn", _NO_AXIS))
    if spec.ffn in ("moe", "moe_dense"):
        moe_tp = regions.get("moe", _NO_AXIS)
        hm = moe_tp.enter(h)
        if cfg.moe_weight_shard == "f":
            mo, aux = moe_ffn_fshard(hm, p["moe"], cfg, ax, mesh, batch_axes)
        else:
            mo, aux = moe_ffn(hm, p["moe"], cfg,
                              name_output=cfg.remat and cfg.remat_policy == "save_moe")
        mo = moe_tp.exit(mo)
        out = mo if out is None else out + mo
    return x + out, aux


def apply_layer(x: torch.Tensor, p: dict, spec: LayerSpec, cfg: ModelConfig,
                ax: Axes | None = None, mesh=None, img_embeds=None, batch_axes: tuple = (),
                regions: dict | None = None):
    """One layer of the full-sequence forward on plain tensors (a rank's
    batch rows, under ``"seq"`` their stripe of the sequence, and the
    layer's weights, this rank's chunks of a split region's; expert weights
    under ``moe_weight_shard="f"`` stay DTensors). ``regions`` maps each of
    the layer's regions (``"attn"``, ``"mamba"``, ``"ffn"``, ``"moe"``) to
    its ``ModelAxis`` (:meth:`Model.regions`; none split where absent).
    Returns ``(x, aux, cache)``: the router loss of its MoE (zero without
    one) and the cache entry its mixer made (``(k, v)``, the MLA latent or
    the Mamba states; whole over the sequence, a split region's this rank's
    heads or channels)."""
    regions = regions or {}
    h = rms_norm(x, p["norm1"])
    if spec.mixer == "mamba":
        y, cache = mamba_forward(h, p["mamba"], cfg, tp=regions.get("mamba", _NO_AXIS))
    else:
        tp = regions.get("attn", _NO_AXIS)
        if spec.mixer == "attn" and cfg.use_mla:
            y, cache = mla_forward(h, p["attn"], cfg, window=spec.window, tp=tp)
        elif spec.mixer == "attn":
            y, cache = gqa_forward(h, p["attn"], cfg, window=spec.window, tp=tp)
        else:
            y, cache = gqa_forward(h, p["attn"], cfg, window=None, kv_x=img_embeds, tp=tp)
    x, aux = _ffn(x + y, p, spec, cfg, ax, mesh, batch_axes, regions)
    return x, aux, cache


def _paths(tree: dict, prefix: tuple = ()):
    """``(path, leaf)`` of every leaf of a nest of dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unpaths(flat: dict) -> dict:
    """The nest of dicts whose leaves ``flat`` maps by path."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


# a model axis of one rank: no region split, nothing moves
_NO_AXIS = ModelAxis()
# the leaves a layer reads on the residual stream (under "seq", on stripes):
# its norms' scales, the cross-attention gate (applied after the sum), and
# ("scale",) the final norm's
_RESIDUAL = (("norm1", "scale"), ("norm2", "scale"), ("attn", "gate"), ("scale",))
# the leaves of each region that the specs split over the model axis when
# the region is split
_SPLIT_LEAVES = {
    "gqa": ("wq", "wo"),
    "mla": ("wkv_b", "wo"),
    "mamba": ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "a_log", "d_skip",
              "out_proj"),
    "ffn": ("w_in", "w_out"),
}


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

    def batch_split(self, batch: dict, rows_dim: int = 0) -> tuple:
        """``(mesh, mesh dims)`` for a batch of this model: the mesh dims that
        shard its rows (dim ``rows_dim`` of the tokens' or frames' DTensor:
        1 under a leading microbatch axis); ``(None, ())`` for plain
        tensors. The model axis never counts: under ``"seq"`` the head sees
        the whole sequence on every rank of it."""
        from torch.distributed.tensor import DTensor, Shard

        t = batch.get("tokens", batch.get("frames"))
        if not isinstance(t, DTensor):
            return None, ()
        return t.device_mesh, tuple(i for i, pl in enumerate(t.placements)
                                    if isinstance(pl, Shard) and pl.dim == rows_dim)

    def model_axis(self, stripe: Stripe | None = None) -> ModelAxis:
        """This rank's :class:`~repro_torch.launch.mesh.ModelAxis` (with
        ``stripe`` under ``"seq"``); ``ModelAxis()``, which splits nothing,
        without a mesh or on a model axis of one rank."""
        if self.mesh is None or self.mesh.size(self.mesh.mesh_dim_names.index(self.ax.tp)) == 1:
            return _NO_AXIS
        return ModelAxis.of(self.mesh, self.ax.tp, stripe)

    def regions(self, p: dict, tp: ModelAxis) -> dict:
        """Each region of a layer (its params ``p``, DTensors on a mesh)
        mapped to ``tp`` handed to it, split or not
        (:meth:`_region_split`); the MoE's never split. The one place the
        split is decided: the weights' gathers (:meth:`_weights`), the
        modules' products and a decode step's cache follow it."""
        out = {r: tp.region(tp.size > 1 and self._region_split(r, p[r]))
               for r in ("attn", "mamba", "ffn") if r in p}
        out["moe"] = tp.region(False)
        return out

    def _vocab_region(self, leaf, tp: ModelAxis) -> ModelAxis:
        """``tp`` handed to the embedding or the head (``leaf``, their
        weight): split where the specs split the vocabulary over it."""
        return tp.region(tp.size > 1 and self._sharded_on_model(leaf))

    def vocab_axis(self, params: dict, stripe: Stripe | None = None) -> ModelAxis:
        """The head's model axis: split where the specs split the vocabulary
        over it (the logits are then this rank's columns)."""
        head = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        return self._vocab_region(head, self.model_axis(stripe))

    def _local(self, inputs: dict, split_seq: bool = True) -> tuple[dict, tuple, Stripe | None]:
        """Plain tensors on the model's device for ``inputs`` (DTensors split
        over the data axes, or plain tensors; whole over the sequence), the
        mesh axes that split their batch, and with ``split_seq`` the rank's
        stripe of the sequence (:meth:`seq_stripe`)."""
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
        return out, batch_axes, stripe

    def _region_split(self, name: str, p: dict) -> bool:
        """Whether region ``name`` (a layer's ``"attn"``, ``"mamba"``,
        ``"ffn"`` dict of DTensors) is split over the model axis: the specs
        split its weights there (after sanitising) with chunks a rank can
        use, the products of one set of heads, channels or hidden units."""
        from torch.distributed.tensor import DTensor, Shard

        if name == "attn":
            kind = "mla" if "wkv_b" in p else "gqa"
            if kind == "gqa" and isinstance(p["wq"], DTensor):
                # heads need a contiguous column chunk: not "f" over data ranks
                tp_i = self.mesh.mesh_dim_names.index(self.ax.tp)
                if any(isinstance(pl, Shard) and pl.dim == 1 and i != tp_i
                       for i, pl in enumerate(p["wq"].placements)):
                    return False
            keys = _SPLIT_LEAVES[kind] + (("wq_b" if "wq_b" in p else "wq"),)
        else:
            keys = _SPLIT_LEAVES[name]
        return all(self._sharded_on_model(p[k]) for k in keys)

    def _weights(self, tree, batch_axes: tuple, spec: LayerSpec | None = None,
                 tp: ModelAxis = _NO_AXIS, regions: dict | None = None, decode: bool = False):
        """``tree``'s weights (a layer's dict with its ``regions``, a dict of
        the residual stream's, or one top-level leaf whose region is ``tp``)
        on the model's device: gathered over the data axes, their gradients
        read as the batch split over ``batch_axes``. On a model axis of one
        rank everything is gathered whole. Else each leaf is one of:
        a split region's weight that the specs split over the model axis,
        kept as this rank's chunk (``Shard`` gradients there); a split
        region's leaf left whole (``Partial`` over the model axis: each
        rank's products read it for their own share); a leaf of the
        residual stream (norms, the cross-attention gate; ``Partial`` over
        the model axis under ``"seq"``, where they read stripes); anything
        else gathered whole. The decode step gathers MLA's ``wkv_b`` whole:
        the absorbed form reads its columns as the reference's keys-then-
        values layout, not the forward's per-head one that the chunks
        follow. The expert weights of a ``moe_weight_shard="f"`` layer stay
        put."""
        from torch.distributed.tensor import Partial

        if self.mesh is None:
            return tree
        gp = batch_grad_placements(self.mesh, batch_axes)
        tp_i = self.mesh.mesh_dim_names.index(self.ax.tp)
        on_tp = tuple(Partial() if i == tp_i else pl for i, pl in enumerate(gp))
        fshard = spec is not None and "moe" in tree and self.cfg.moe_weight_shard == "f"
        if not isinstance(tree, dict):  # a top-level leaf: the embedding, the head
            kinds = {(): "split" if tp.split else "whole"}
            leaves = {(): tree}
        else:
            leaves, kinds = {}, {}
            regions = regions or {}
            for path, leaf in _paths(tree):
                if fshard and path[0] == "moe" and path[-1] in EXPERT_WEIGHTS and len(path) == 2:
                    continue
                leaves[path] = leaf
                kinds[path] = "whole"
                if path in _RESIDUAL:
                    kinds[path] = "residual"
                elif regions.get(path[0], _NO_AXIS).split:
                    whole = decode and path == ("attn", "wkv_b")
                    kinds[path] = "whole" if whole else \
                        ("split" if self._sharded_on_model(leaf) else "partial")
        groups = {"split": ((self.ax.tp,), gp), "partial": ((), on_tp),
                  "residual": ((), on_tp if tp.stripe is not None else gp),
                  "whole": ((), gp)}
        out = {}
        for kind, (keep, places) in groups.items():
            paths = [q for q, k in kinds.items() if k == kind]
            if paths:
                got = gather_tree([leaves[q] for q in paths], places, self.device, keep)
                out.update(zip(paths, got))
        if not isinstance(tree, dict):
            return out[()]
        if fshard:
            for k in EXPERT_WEIGHTS:
                if k in tree["moe"]:
                    out[("moe", k)] = tree["moe"][k]
        return _unpaths(out)

    def _sharded_on_model(self, t) -> bool:
        from torch.distributed.tensor import DTensor, Shard

        tp_i = self.mesh.mesh_dim_names.index(self.ax.tp)
        return isinstance(t, DTensor) and isinstance(t.placements[tp_i], Shard)

    # --------------------------------------------------------------- forward
    def _embed(self, params: dict, tokens: torch.Tensor, batch_axes: tuple = (),
               tp: ModelAxis = _NO_AXIS) -> torch.Tensor:
        """The tokens' embeddings (all positions of this rank's rows), on
        the residual stream: where ``tp`` (the embedding's region,
        :meth:`_vocab_region`) is split, a masked lookup of this rank's
        vocabulary rows summed over the model axis (under ``"seq"``,
        reduce-scattered to the stripes)."""
        w = self._weights(params["embed"], batch_axes, tp=tp)
        if tp.split:
            local = tokens - tp.rank * w.shape[0]
            own = (local >= 0) & (local < w.shape[0])
            x = w[local.clamp(0, w.shape[0] - 1)].masked_fill(~own[..., None], 0)
        else:
            x = w[tokens]
        x = tp.exit(x)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        return x

    def _head(self, params: dict, x: torch.Tensor, batch_axes: tuple = (),
              tp: ModelAxis = _NO_AXIS) -> torch.Tensor:
        """The logits of the residual stream's ``x``: whole over the
        sequence; where ``tp`` (the head's region, :meth:`vocab_axis`) is
        split, this rank's vocabulary columns ``[..., V / n]``."""
        x = rms_norm(x, self._weights(params["final_norm"], batch_axes, tp=tp))
        leaf = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        w = self._weights(leaf, batch_axes, tp=tp)
        return tp.enter(x) @ (w.T if self.cfg.tie_embeddings else w)

    def whole_vocab(self, params: dict, logits: torch.Tensor) -> torch.Tensor:
        """``logits`` over the whole vocabulary: this rank's columns
        all-gathered over the model axis where the head splits them."""
        tp = self.vocab_axis(params)
        return tp.gather(logits, -1, grad_sum=False) if tp.split else logits

    def forward(self, params: dict, inputs: dict):
        """Full-sequence forward. inputs: ``{"tokens": [B, S]}`` (or
        ``{"frames": [B, S, D]}``, cast to the model's dtype) and optionally
        ``"image_embeds"`` [B, N, D], the source of every cross-attention
        layer (without it such a layer attends to its own input, as the
        reference's does). Returns ``(logits [B, S, V], aux_loss)``;
        ``aux_loss`` is the MoE router loss summed over the layers (float32;
        zero without MoE layers). On a mesh the inputs are DTensors (or this
        rank's rows) and the logits are this rank's rows, on a model axis
        above 1 whose specs split the vocabulary its columns ``[B, S, V /
        n]`` (:meth:`whole_vocab` gathers them); every rank of the model
        axis gets the same ``aux``."""
        cfg = self.cfg
        inputs, batch_axes, stripe = self._local(inputs)
        tp = self.model_axis(stripe)
        if cfg.frontend == "frames":
            x = inputs["frames"].to(self.dtype)
            if stripe is not None:
                x = stripe.keep(x)
        else:
            x = self._embed(params, inputs["tokens"], batch_axes,
                            self._vocab_region(params["embed"], tp))
        img = inputs.get("image_embeds")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for spec, p in zip(cfg.layers(), params["layers"]):
            regions = self.regions(p, tp)
            p = self._weights(p, batch_axes, spec, tp, regions)
            if cfg.remat and _needs_grad(x, p):
                context = checkpoint.noop_context_fn
                if cfg.remat_policy in _POLICIES:
                    context = functools.partial(
                        checkpoint.create_selective_checkpoint_contexts,
                        _POLICIES[cfg.remat_policy])
                x, a = checkpoint.checkpoint(self._layer, x, p, spec, img, batch_axes, regions,
                                             use_reentrant=False, context_fn=context)
            else:
                x, a = self._layer(x, p, spec, img, batch_axes, regions)
            aux = aux + a
        return self._head(params, x, batch_axes, self.vocab_axis(params, stripe)), aux

    def _ffn(self, x: torch.Tensor, p: dict, spec: LayerSpec, batch_axes: tuple = (),
             regions: dict | None = None):
        """The layer's FFN residual: ``(x + out, aux)`` (:func:`_ffn`)."""
        return _ffn(x, p, spec, self.cfg, self.ax, self.mesh, batch_axes, regions)

    def _layer(self, x: torch.Tensor, p: dict, spec: LayerSpec, img=None, batch_axes: tuple = (),
               regions: dict | None = None):
        """One layer of the full-sequence forward: ``(x, aux)``; ``img`` the
        image embeddings a cross-attention layer reads."""
        x, aux, _ = apply_layer(x, p, spec, self.cfg, self.ax, self.mesh, img, batch_axes,
                                regions)
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
    def _decode_gqa(self, x, h, p, cache: dict, pos: int, spec: LayerSpec,
                    tp: ModelAxis = _NO_AXIS):
        cfg = self.cfg
        b = x.shape[0]
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        h = tp.enter(h)
        q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
        h0 = 0
        if tp.split:  # this rank's query heads; the new key and value whole, for the cache
            q, h0 = own_heads(q, dh, tp)
            if k.shape[-1] < hkv * dh:
                kv = tp.gather(torch.cat([k, v], -1), -1).unflatten(-1, (tp.size, 2, -1))
                k, v = kv[..., 0, :].flatten(-2), kv[..., 1, :].flatten(-2)
        else:
            q = q.reshape(b, 1, hq, dh)
        k, v = k.reshape(b, 1, hkv, dh), v.reshape(b, 1, hkv, dh)
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
        kc, vc = cache["k"], cache["v"]
        nq = q.shape[2]
        if tp.split:  # the KV heads this rank's query heads read (a view of the cache)
            g = hq // hkv
            kv0, kv1 = h0 // g, (h0 + nq - 1) // g + 1
            kc, vc = _launch_kv(kc[:, :, kv0:kv1], vc[:, :, kv0:kv1], h0, nq, g, kv0)
        out = gqa_flash_decode(q[:, 0], kc, vc, pos, None if ring else spec.window)  # [B, H, Dh]
        y = out.reshape(b, 1, nq * dh)
        if tp.split:
            y = own_cols(y, h0, dh, p["wo"].shape[0], tp)
        return x + tp.exit(row_product(y, p["wo"], tp.split)).to(x.dtype)

    def _decode_mla(self, x, h, p, cache: dict, pos: int, tp: ModelAxis = _NO_AXIS):
        """The absorbed-form MLA step, as the reference's ``_decode_mla``: the
        new latent row (``c_kv``, the RoPE'd ``k_pe``) written at ``pos``,
        ``q_nope`` taken into the latent space by ``w_uk``, one launch over
        the latent cache, the context taken back out by ``w_uv``. The
        absorbed projections are einsums, as the reference computes them
        outside any kernel. They split ``wkv_b``'s columns into a first
        ``H * nope`` (keys) and a last ``H * v_head_dim`` (values), where the
        forward reads it per head (``[nope + v_head_dim]`` a head): the
        reference's own layouts, copied. Where ``tp.split``, this rank's query
        heads (``wq_b``'s chunk; their blocks of ``w_uk`` and
        ``w_uv`` from ``wkv_b``, which the decode step gathers whole) go
        through one launch over the whole latent cache, and ``wo``'s row
        chunk to the sum."""
        cfg = self.cfg
        b = x.shape[0]
        nh = cfg.n_heads
        nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        h = tp.enter(h)
        if cfg.q_lora_rank:
            qa = rms_norm(h @ p["wq_a"], {"scale": p["q_norm"]})
            q = qa @ p["wq_b"]
        else:
            q = h @ p["wq"]
        h0, h1 = 0, nh
        if tp.split:
            q, h0 = own_heads(q, nope + rope_d, tp)
            h1 = h0 + q.shape[2]
        else:
            q = q.reshape(b, 1, nh, nope + rope_d)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        posv = torch.full((b, 1), pos, device=x.device)
        q_pe = apply_rope(q_pe, posv, cfg.rope_theta)
        kv_a = h @ p["wkv_a"]  # [B, 1, r + rope]
        c_kv = rms_norm(kv_a[..., :r], {"scale": p["kv_norm"]})
        k_pe = apply_rope(kv_a[..., None, r:], posv, cfg.rope_theta)[:, :, 0]
        cache["ckv"][:, pos] = c_kv[:, 0].to(cache["ckv"].dtype)
        cache["kpe"][:, pos] = k_pe[:, 0].to(cache["kpe"].dtype)
        w_uk = p["wkv_b"][:, : nh * nope].reshape(r, nh, nope)[:, h0:h1]
        w_uv = p["wkv_b"][:, nh * nope :].reshape(r, nh, vd)[:, h0:h1]
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
        ctx_lat = mla_flash_decode(q_lat, q_pe[:, 0], cache["ckv"], cache["kpe"], pos)
        out = torch.einsum("bhr,rhv->bhv", ctx_lat, w_uv).reshape(b, 1, (h1 - h0) * vd)
        if tp.split:
            out = own_cols(out, h0, vd, p["wo"].shape[0], tp)
        return x + tp.exit(row_product(out, p["wo"], tp.split)).to(x.dtype)

    def _decode_layer(self, x, p, spec: LayerSpec, cache: dict, pos: int,
                      batch_axes: tuple = (), regions: dict | None = None):
        """One-token step for one layer. x: [B, 1, D]; ``cache`` is updated;
        ``regions`` as :func:`apply_layer`'s."""
        regions = regions or {}
        h = rms_norm(x, p["norm1"])
        tp = regions.get("mamba" if spec.mixer == "mamba" else "attn", _NO_AXIS)
        if spec.mixer == "attn" and self.cfg.use_mla:
            x = self._decode_mla(x, h, p["attn"], cache, pos, tp)
        elif spec.mixer == "attn":
            x = self._decode_gqa(x, h, p["attn"], cache, pos, spec, tp)
        elif spec.mixer == "cross_attn":
            x = x + gqa_cross_decode(h, p["attn"], self.cfg, cache["k_img"], cache["v_img"], tp)
        else:
            y, (cache["conv"], cache["ssm"]) = mamba_decode_step(
                h, p["mamba"], self.cfg, cache["conv"], cache["ssm"], tp)
            x = x + y
        # the router loss of a decode step is dropped
        x, _ = self._ffn(x, p, spec, batch_axes, regions)
        return x

    def _kept(self, keep_tp: bool):
        """The mesh dims whose shards a layer's cache keeps on this rank: the
        data axes, and the model axis for a Mamba layer split over it."""
        return set(self.ax.dp) | ({self.ax.tp} if keep_tp else set())

    def _cache_in(self, cache: dict, keep_tp: bool = False) -> dict:
        """A layer's cache on the model's device: this rank's batch rows,
        whole over every other axis (an all-gather over the model axis where
        the spec shards it) but the model axis with ``keep_tp`` (a Mamba
        state on this rank's channels). An MLA layer's two leaves become
        views of one buffer again, which the absorbed decode reads in one
        launch."""
        from torch.distributed.tensor import Replicate

        kept = self._kept(keep_tp)
        out = {}
        for name, t in cache.items():
            keep = tuple(pl if n in kept else Replicate()
                         for n, pl in zip(self.mesh.mesh_dim_names, t.placements))
            out[name] = t.redistribute(self.mesh, keep).to_local().to(self.device)
        if "ckv" in out:
            r = out["ckv"].shape[-1]
            latent = torch.cat([out["ckv"], out["kpe"]], dim=-1)
            out = {"ckv": latent[..., :r], "kpe": latent[..., r:]}
        return out

    def _cache_out(self, cache: dict, stepped: dict, keep_tp: bool = False) -> None:
        """Each leaf of ``cache`` (DTensors) replaced by this rank's shard of
        the stepped layer cache (a slice, no communication)."""
        from torch.distributed.tensor import DTensor, Replicate

        kept = self._kept(keep_tp)
        for name, t in cache.items():
            split = tuple(Replicate() if n in kept else pl
                          for n, pl in zip(self.mesh.mesh_dim_names, t.placements))
            local = local_slice(stepped[name], split, self.mesh).contiguous()
            cache[name] = DTensor.from_local(local.to(t.device), self.mesh, t.placements,
                                             run_check=False, shape=t.shape, stride=t.stride())

    def decode_step(self, params: dict, cache: list, tokens: torch.Tensor, pos: int):
        """One decode step. tokens: [B, 1]; ``pos`` the position being
        written. Returns ``(logits [B, 1, V], cache)``, the cache updated in
        place. On a mesh ``tokens`` is a DTensor (or this rank's rows), the
        cache a list of dicts of DTensors placed by ``cache_specs``, and the
        logits are this rank's rows, over the whole vocabulary."""
        if self.cfg.is_encoder_only:
            raise ValueError(f"{self.cfg.name} is encoder-only: it has no decode path")
        inputs, batch_axes, _ = self._local({"tokens": tokens}, split_seq=False)
        tp = self.model_axis()
        x = self._embed(params, inputs["tokens"], batch_axes,
                        self._vocab_region(params["embed"], tp))
        for spec, p, c in zip(self.cfg.layers(), params["layers"], cache):
            regions = self.regions(p, tp)
            p = self._weights(p, batch_axes, spec, tp, regions, decode=True)
            if self.mesh is None:
                x = self._decode_layer(x, p, spec, c, pos, batch_axes)
                continue
            keep_tp = regions.get("mamba", _NO_AXIS).split  # a state on this rank's channels
            stepped = self._cache_in(c, keep_tp)
            x = self._decode_layer(x, p, spec, stepped, pos, batch_axes, regions)
            self._cache_out(c, stepped, keep_tp)
        logits = self._head(params, x, batch_axes, self.vocab_axis(params))
        return self.whole_vocab(params, logits), cache
