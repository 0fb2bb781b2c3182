"""Shared layers: RMS norms, RoPE, the dense FFN and the MoE.

Each upcasts to float32 and casts back exactly where the reference's
``repro.models.layers`` does, so both packages round at the same places.

The MoE is the reference's expert-parallel ``moe_ffn`` with the expert axis
whole on one card: at one shard its two token all-to-alls are the identity
and its FSDP weight gathers no-ops, so what is left is routing, the
capacity-bounded dispatch, the expert products and the combine, in the
reference's arithmetic and order.
"""
from __future__ import annotations

import functools

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
    dh = x.shape[-1]
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


def dense_ffn(x: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    h = x @ p["w_in"]
    g = x @ p["w_gate"] if "w_gate" in p else None
    return _act(h, g, activation) @ p["w_out"]


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


def _moe_ffn(x: torch.Tensor, p: dict, cfg, name_output: bool):
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    tl = b * s
    cap = moe_capacity(tl, cfg)
    tokens = x.reshape(tl, d)
    probs = torch.softmax(tokens.float() @ p["router"], dim=-1)
    w_topk, idx = top_k(probs, k)  # [Tl, k]
    w_topk = w_topk / w_topk.sum(-1, keepdim=True).clamp_min(1e-9)
    # the Switch aux loss, on each token's first choice
    frac_routed = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * (frac_routed * probs.mean(0)).mean()
    e_flat = idx.reshape(-1)  # [Tl*k]
    pos = positions_in_expert(e_flat, e)
    keep = pos < cap
    dest = torch.where(keep, e_flat * cap + pos, e * cap)  # e*cap: the overflow slot
    send = x.new_zeros((e * cap + 1, d)).index_put((dest,), tokens.repeat_interleave(k, dim=0))
    y = expert_products(send[: e * cap].reshape(e, cap, d), p, cfg.activation).to(x.dtype)
    ret_flat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    vals = ret_flat[dest].float() * (keep * w_topk.reshape(-1))[:, None]
    out = vals.reshape(tl, k, d).sum(1).to(x.dtype).reshape(b, s, d)
    if name_output:
        out = moe_out(out)
    if "shared" in p:
        out = out + dense_ffn(x, p["shared"], cfg.activation)
    return out, aux
