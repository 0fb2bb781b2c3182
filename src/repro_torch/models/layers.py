"""Shared layers: RMS norms, RoPE, the dense FFN and the MoE, each with its
initialiser and its sharding specs.

Each upcasts to float32 and casts back exactly where the reference's
``repro.models.layers`` does, so both packages round at the same places.

Sharding convention (the reference's): ``ax.tp`` is the tensor-parallel
mesh axis (``"model"``), ``ax.dp`` the tuple of data axes the parameters are
FSDP-sharded over (``("data",)``, or ``("pod", "data")`` across pods). Every
``init_*`` has a ``specs_*`` that mirrors its tree with a spec at each leaf.

The initialisers draw from an :class:`Init`: seeded normals on a device, or,
with ``Init.shapes()``, empty tensors on the ``meta`` device (shapes and
dtypes, nothing drawn, nothing allocated). The draws come in one fixed order
per leaf kind, which is what makes ``Model.init`` reproducible.

The MoE is the reference's expert-parallel ``moe_ffn`` with the expert axis
whole on each rank: at one shard its two token all-to-alls are the identity
and its FSDP weight gathers no-ops, so what is left is routing, the
capacity-bounded dispatch, the expert products and the combine, in the
reference's arithmetic and order. On a mesh each rank runs it on its own
batch rows with the gathered weights, as the reference's ``shard_map`` does
on each data shard (the capacity and the aux loss are per shard there too).
``moe_ffn_fshard`` is the weight-stationary MoE (decode, and a train step
under ``moe_weight_shard="f"``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import ModelAxis, P


@dataclasses.dataclass(frozen=True)
class Axes:
    dp: tuple[str, ...] = ("data",)
    tp: str = "model"

    @property
    def batch(self):
        return self.dp  # activation batch axes


class Init:
    """Where the initialisers' numbers come from: ``normal(shape, scale)``
    draws ``randn * scale`` from ``generator`` on ``device`` (one draw a
    call, in call order); ``ones``/``zeros``/``a_log`` are deterministic.
    ``Init.shapes()`` makes every call an empty ``meta`` tensor."""

    def __init__(self, generator: torch.Generator | None, device):
        self.generator = generator
        self.device = torch.device(device)

    @classmethod
    def shapes(cls) -> "Init":
        return cls(None, "meta")

    @property
    def meta(self) -> bool:
        return self.device.type == "meta"

    def normal(self, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, dtype=dtype, device="meta")
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=dtype).mul_(scale)

    def ones(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones(n, dtype=dtype, device=self.device)

    def zeros(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(n, dtype=dtype, device=self.device)

    def a_log(self, di: int, n: int) -> torch.Tensor:
        """``log(1..n)`` on every one of ``di`` rows (Mamba's ``A``)."""
        if self.meta:
            return torch.empty((di, n), dtype=torch.float32, device="meta")
        return torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=self.device)) \
            .expand(di, n).contiguous()


# --------------------------------------------------------------------- norms
def init_rmsnorm(init: Init, d: int, dtype: torch.dtype) -> dict:
    return {"scale": init.ones(d, dtype)}


def specs_rmsnorm() -> dict:
    return {"scale": P(None)}


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


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(dh: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` computed on the host and copied to ``device`` once: a
    card's ``pow`` may round a frequency an ulp away from the host's, and
    the angle ``pos * freq`` multiplies that ulp by the position, so at a
    long cache the card's logits would leave the CPU's by more than the
    float32 tolerance (1e-4)."""
    return rope_freqs(dh, theta).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T]. Rotates the two halves of
    the head (``x1, x2 = split``), not interleaved pairs."""
    from torch._subclasses.fake_tensor import FakeTensor

    dh = x.shape[-1]
    if isinstance(x, FakeTensor):  # a dry run's shapes: keep fake tensors out of the cache
        freqs = rope_freqs(dh, float(theta), x.device)
    else:
        freqs = _rope_freqs_on(dh, float(theta), x.device)  # [Dh/2]
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


def init_dense_ffn(init: Init, d: int, f: int, activation: str, dtype: torch.dtype) -> dict:
    p = {"w_in": init.normal((d, f), d**-0.5, dtype), "w_out": init.normal((f, d), f**-0.5, dtype)}
    if activation == "swiglu":
        p["w_gate"] = init.normal((d, f), d**-0.5, dtype)
    return p


def specs_dense_ffn(ax: Axes, activation: str, weight_shard: str = "d") -> dict:
    if weight_shard == "f":
        # weight-stationary: the hidden dim over every axis
        full = (*ax.dp, ax.tp)
        p = {"w_in": P(None, full), "w_out": P(full, None)}
        if activation == "swiglu":
            p["w_gate"] = P(None, full)
        return p
    p = {"w_in": P(ax.dp, ax.tp), "w_out": P(ax.tp, ax.dp)}
    if activation == "swiglu":
        p["w_gate"] = P(ax.dp, ax.tp)
    return p


def row_product(y: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    """``y @ w``; where ``split`` (a row-parallel product's partial, to be
    summed over the model axis) with a float32 result from lower-precision
    operands, which the caller rounds once, after the sum. The reference's
    partitioned dot, as XLA compiles it on the host, does the same: a
    float32 all-reduce of the dot's partials, then one convert. The ranks'
    partials add in another order than one device's products, so the
    rounded result can differ from one device's by a unit in the last place.
    On a card the operands stay bf16 on the tensor cores (``torch.mm``'s
    ``out_dtype``); on the host they are converted."""
    if not split or y.dtype not in (torch.bfloat16, torch.float16):
        return y @ w
    if y.is_cuda:
        return _Float32Product.apply(y, w)
    return y.float() @ w.float()


class _Float32Product(torch.autograd.Function):
    """``y @ w`` ``[..., K] x [K, N]`` in a float32 result from
    lower-precision operands on the tensor cores; backward in the operands'
    dtype, as one device's product's is."""

    @staticmethod
    def forward(ctx, y, w):
        ctx.save_for_backward(y, w)
        out = torch.mm(y.reshape(-1, y.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*y.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(y.dtype)
        gy = (g2 @ w.t()).reshape(y.shape) if ctx.needs_input_grad[0] else None
        gw = y.reshape(-1, y.shape[-1]).t() @ g2 if ctx.needs_input_grad[1] else None
        return gy, gw


def dense_ffn(x: torch.Tensor, p: dict, activation: str, tp: ModelAxis = ModelAxis()
              ) -> torch.Tensor:
    """``act(x @ w_in, x @ w_gate) @ w_out``, a tensor-parallel region: its
    input enters and its output exits through ``tp`` (a
    ``launch.mesh.ModelAxis``); where ``tp.split`` the weights are this
    rank's chunks (``w_in`` and ``w_gate`` columns, ``w_out`` rows, as
    ``specs_dense_ffn`` places them; under ``weight_shard="f"`` the model
    axis's blocks of every data shard, the same hidden units in all three)
    and the partial outputs are summed."""
    x = tp.enter(x)
    h = x @ p["w_in"]
    g = x @ p["w_gate"] if "w_gate" in p else None
    return tp.exit(row_product(_act(h, g, activation), p["w_out"], tp.split)).to(x.dtype)


# ------------------------------------------------------------------- the MoE
# the profiler range around each MoE layer (what its share of device time
# is read from)
MOE_RANGE = "repro_torch.moe"
# the float32 expert weights made at once: the reference's einsums upcast
# every expert's bf16 weights together (17.8 GB for arctic-480b's ``w_out``);
# the port does the same arithmetic on slices of the expert axis, each
# holding at most this many bytes of one float32 weight
EXPERT_F32_BYTES = 1 << 30


@torch.library.custom_op("repro_torch::moe_out", mutates_args=())
def moe_out(y: torch.Tensor) -> torch.Tensor:
    """The identity, as an operator of its own: it names the MoE layer's
    output, as the reference's ``checkpoint_name(y, "moe_out")`` does, so
    that the ``save_moe`` remat policy can keep exactly this tensor."""
    return y.clone()


@moe_out.register_fake
def _(y):
    return torch.empty_like(y)


moe_out.register_autograd(lambda ctx, grad: grad)


def init_moe(init: Init, d: int, f: int, n_experts: int, n_shared: int, activation: str,
             dtype: torch.dtype) -> dict:
    p = {  # the router stays float32 in a bf16 model
        "router": init.normal((d, n_experts), d**-0.5, torch.float32),
        "w_in": init.normal((n_experts, d, f), d**-0.5, dtype),
        "w_out": init.normal((n_experts, f, d), f**-0.5, dtype),
    }
    if activation == "swiglu":
        p["w_gate"] = init.normal((n_experts, d, f), d**-0.5, dtype)
    if n_shared:
        p["shared"] = init_dense_ffn(init, d, n_shared * f, activation, dtype)
    return p


def specs_moe(ax: Axes, activation: str, n_shared: int) -> dict:
    p = {"router": P(None, None), "w_in": P(ax.tp, ax.dp, None), "w_out": P(ax.tp, None, ax.dp)}
    if activation == "swiglu":
        p["w_gate"] = P(ax.tp, ax.dp, None)
    if n_shared:
        p["shared"] = specs_dense_ffn(ax, activation)
    return p


def specs_moe_fshard(ax: Axes, activation: str, n_shared: int) -> dict:
    """Decode-mode expert weights: the hidden dim sharded over the data
    axes, never gathered over them (they dwarf a decode step's tokens)."""
    p = {"router": P(None, None), "w_in": P(ax.tp, None, ax.dp), "w_out": P(ax.tp, ax.dp, None)}
    if activation == "swiglu":
        p["w_gate"] = P(ax.tp, None, ax.dp)
    if n_shared:
        p["shared"] = specs_dense_ffn(ax, activation)
    return p


def positions_in_expert(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """pos[i] = rank of entry i within its expert group, in entry order (the
    reference's sort-based ``_positions_in_expert``; its ``argsort`` is
    stable, and so is this one's)."""
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    start = torch.searchsorted(sorted_e, torch.arange(n_experts, device=e_flat.device,
                                                      dtype=e_flat.dtype))
    pos_sorted = torch.arange(e_flat.shape[0], device=e_flat.device) - start[sorted_e]
    return torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their indices, largest
    first, the lower index first among equal values (``jax.lax.top_k``'s
    order; ``torch.topk`` does not promise one)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(tokens: int, cfg) -> int:
    """Slots an expert takes per call: the reference's ``cap``. The floor of
    8 aligns training tiles; a decode batch (``tokens * top_k < 8 * E``)
    takes a floor of 1, so at B=8 and top-2 every expert keeps one (token,
    slot) pair a step and drops the rest, as the reference does."""
    e, k = cfg.n_experts, cfg.top_k
    cap_floor = 8 if tokens * k >= 8 * e else 1
    return int(max(cap_floor, (-(-tokens * k // e)) * cfg.capacity_factor))


def expert_products(grouped: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    """Every expert's FFN over its ``cap`` rows. grouped: ``[E, cap, D]``.
    Float32 end to end, as the reference's ``preferred_element_type``
    einsums: each weight is upcast and multiplied in float32 (a bf16 product
    is exact in float32, so this is the reference's bf16 x bf16 -> float32
    product), a slice of experts at a time (``EXPERT_F32_BYTES``). Returns
    ``[E, cap, D]`` float32."""
    e, _, d = grouped.shape
    f = p["w_in"].shape[-1]
    per = max(1, EXPERT_F32_BYTES // (d * f * 4))
    xg = grouped.float()
    outs = []
    for lo in range(0, e, per):
        hi = min(e, lo + per)
        h = torch.bmm(xg[lo:hi], p["w_in"][lo:hi].float())
        g = torch.bmm(xg[lo:hi], p["w_gate"][lo:hi].float()) if "w_gate" in p else None
        outs.append(torch.bmm(_act(h, g, activation), p["w_out"][lo:hi].float()))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def moe_ffn(x: torch.Tensor, p: dict, cfg, name_output: bool = False):
    """Top-k routed MoE on one card. x: ``[B, S, D]``. Returns ``(y, aux)``:
    ``y`` in x's dtype and the Switch load-balance loss (float32 scalar).

    Routing in float32 (softmax, top-k, weights renormalised); each expert
    takes ``moe_capacity`` (token, slot) pairs in entry order and drops the
    rest (their rows go to an overflow slot that is discarded, and their
    weight to zero); the experts' products in float32
    (:func:`expert_products`), cast to x's dtype where the reference casts;
    the combine sums the k weighted outputs in float32. Shared experts are
    added outside. ``name_output`` passes the routed output through
    :func:`moe_out`, the name the ``save_moe`` remat policy keeps. The
    layer runs inside the profiler range ``MOE_RANGE``."""
    with torch.profiler.record_function(MOE_RANGE):
        return _moe_ffn(x, p, cfg, name_output)


def _route(tokens: torch.Tensor, router: torch.Tensor, cfg):
    """Routing and dispatch of ``tokens`` [T, D]: ``(cap, send, dest, keep,
    w_topk, aux)``, ``send`` the ``[E * cap + 1, D]`` dispatch buffer (its
    last row the overflow slot)."""
    e, k = cfg.n_experts, cfg.top_k
    tl, d = tokens.shape
    cap = moe_capacity(tl, cfg)
    probs = torch.softmax(tokens.float() @ router, dim=-1)
    w_topk, idx = top_k(probs, k)  # [Tl, k]
    w_topk = w_topk / w_topk.sum(-1, keepdim=True).clamp_min(1e-9)
    # the Switch aux loss, on each token's first choice
    frac_routed = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * (frac_routed * probs.mean(0)).mean()
    e_flat = idx.reshape(-1)  # [Tl*k]
    pos = positions_in_expert(e_flat, e)
    keep = pos < cap
    dest = torch.where(keep, e_flat * cap + pos, e * cap)  # e*cap: the overflow slot
    send = tokens.new_zeros((e * cap + 1, d)).index_put((dest,), tokens.repeat_interleave(k, dim=0))
    return cap, send, dest, keep, w_topk, aux


def _combine(y: torch.Tensor, dest, keep, w_topk, k: int) -> torch.Tensor:
    """The k weighted expert outputs of each token summed in float32:
    ``[T, D]`` in ``y``'s dtype; ``y`` is ``[E, cap, D]``."""
    d = y.shape[-1]
    ret_flat = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))])
    vals = ret_flat[dest].float() * (keep * w_topk.reshape(-1))[:, None]
    return vals.reshape(-1, k, d).sum(1).to(y.dtype)


def _moe_ffn(x: torch.Tensor, p: dict, cfg, name_output: bool):
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    cap, send, dest, keep, w_topk, aux = _route(x.reshape(b * s, d), p["router"], cfg)
    y = expert_products(send[: e * cap].reshape(e, cap, d), p, cfg.activation).to(x.dtype)
    out = _combine(y, dest, keep, w_topk, k).reshape(b, s, d)
    if name_output:
        out = moe_out(out)
    if "shared" in p:
        out = out + dense_ffn(x, p["shared"], cfg.activation)
    return out, aux


EXPERT_WEIGHTS = ("w_in", "w_gate", "w_out")


def moe_ffn_fshard(x: torch.Tensor, p: dict, cfg, ax: Axes | None = None, mesh=None,
                   batch_axes: tuple = ()):
    """The weight-stationary MoE (the reference's ``moe_ffn_fshard``,
    ``moe_weight_shard="f"``). x: ``[B, S, D]``, this rank's batch rows when
    ``batch_axes`` split the batch. Returns ``(y, aux)``.

    On a mesh the expert weights stay DTensors placed by
    :func:`specs_moe_fshard`: each rank holds an F-slice of every expert
    over the data axes. The tokens are all-gathered over ``batch_axes``;
    routing, capacity and the aux loss are computed on all of them (as the
    reference's, so every rank routes alike); each rank computes its F-slice
    of every expert product from its own weight shards, and the partial
    outputs are summed over the data axes that shard F (an all-reduce),
    then each rank keeps its own rows. Over the model axis the reference
    spreads the experts with two token all-to-alls; the port gathers the
    experts' F-slices over that axis instead (the tokens stay put). The
    products are float32 end to end, as in :func:`moe_ffn`. Without a mesh
    (or on plain tensors) this is :func:`moe_ffn`'s arithmetic on one
    shard.

    It is differentiable on a mesh: the row gather's gradient is
    reduce-scattered over the data axes (every rank's routing and products
    read every row), the partial outputs' gradient all-reduced (every rank's
    rows read the summed output), and the expert weights' gradients land as
    their F-slices, never gathered; the model axis's ranks compute the same
    gradient (under ``"seq"`` too: the MoE runs on the whole sequence), which
    is kept once."""
    with torch.profiler.record_function(MOE_RANGE):
        return _moe_ffn_fshard(x, p, cfg, ax or Axes(), mesh, tuple(batch_axes))


def _moe_ffn_fshard(x, p, cfg, ax: Axes, mesh, batch_axes: tuple):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import local_slice

    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    w = {n: p[n] for n in EXPERT_WEIGHTS if n in p}
    sharded = mesh is not None and any(isinstance(t, DTensor) for t in w.values())
    xg, sum_dims, rows = x, (), None
    if sharded:
        names = mesh.mesh_dim_names

        def partial_on(dims):
            return tuple(Partial() if i in dims else Replicate() for i in range(len(names)))

        # a host mesh holds its shards on the CPU; the products run on x's device
        if batch_axes:
            rows = tuple(Shard(0) if n in batch_axes else Replicate() for n in names)
            row_dims = [names.index(a) for a in batch_axes]
            xg = DTensor.from_local(x, mesh, rows, run_check=False).full_tensor(
                grad_placements=partial_on(row_dims)).to(x.device)
        dp_dims = [names.index(a) for a in ax.dp]
        local = {}
        for n, t in w.items():  # the model axis gathered, the data axes' F-slices kept
            places = tuple(pl if i in dp_dims else Replicate() for i, pl in enumerate(t.placements))
            local[n] = t.redistribute(mesh, places).to_local(grad_placements=places).to(x.device)
        # the data dims that split F: their partial products are summed
        sum_dims = tuple(i for i in dp_dims if isinstance(w["w_in"].placements[i], Shard))
        w = local
    tl = xg.shape[0] * s
    cap, send, dest, keep, w_topk, aux = _route(xg.reshape(tl, d), p["router"], cfg)
    y = expert_products(send[: e * cap].reshape(e, cap, d), w, cfg.activation)  # F-slice
    if sum_dims:
        y = DTensor.from_local(y, mesh, partial_on(sum_dims), run_check=False).full_tensor(
            grad_placements=partial_on(sum_dims)).to(x.device)
    y = y.to(x.dtype)
    out = _combine(y, dest, keep, w_topk, k).reshape(xg.shape)
    if rows is not None:  # this rank's batch rows back
        out = local_slice(out, rows, mesh)
    if "shared" in p:
        out = out + dense_ffn(x, p["shared"], cfg.activation)
    return out, aux
