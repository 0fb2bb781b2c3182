"""Sharded stand-ins for the dry run (port of ``repro.launch.specs``):
divisibility sanitising of specs, allocation-free DTensors of a tree of
shapes, the batch's, the gradient-accumulation factor and the analytic
MODEL_FLOPS the roofline reads.

A dim whose axes do not divide it is replicated (hubert's vocab of 504 on
a 16-way model axis), as in the reference; DTensor's uneven shards are not
used. ``sds`` gives a DTensor whose local shard is a fake tensor under an
active ``FakeTensorMode`` (what the dry run traces with) and a ``meta``
tensor otherwise: either way nothing is allocated.
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import P, axis_sizes, entry_axes, placements
from repro_torch.models.config import ModelConfig

__all__ = ["analytic_model_flops", "batch_specs", "contiguous_stride", "local_shape",
           "pick_accum", "sanitize_spec", "sds", "sds_tree"]


def sanitize_spec(shape, spec: P, mesh) -> P:
    """``spec`` with each entry whose axes' product does not divide its dim
    replaced by ``None``, padded with ``None`` to ``len(shape)``."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        size = math.prod(sizes[a] for a in entry_axes(entry))
        out.append(entry if i < len(shape) and shape[i] % size == 0 else None)
    while len(out) < len(shape):
        out.append(None)
    return P(*out)


def local_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """One rank's shard shape of ``shape`` under a sanitised ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in entry_axes(e)) for n, e in zip(shape, spec))


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def sds(shape, dtype: torch.dtype, spec: P, mesh):
    """An empty DTensor of global ``shape`` placed by the sanitised
    ``spec``: a fake local shard under the active fake mode, else a
    ``meta`` one."""
    from torch._guards import detect_fake_mode
    from torch.distributed.tensor import DTensor

    shape = tuple(int(n) for n in shape)
    spec = sanitize_spec(shape, spec, mesh)
    device = mesh.device_type if detect_fake_mode() is not None else "meta"
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def sds_tree(shapes_tree, specs_tree, mesh):
    """:func:`sds` over a tree of tensors (only their shapes and dtypes are
    read) and its tree of specs."""
    from repro_torch.train.pytree import tree_map

    return tree_map(lambda t, s: sds(t.shape, t.dtype, s, mesh), shapes_tree, specs_tree)


def batch_specs(cfg: ModelConfig, shape: dict, mesh, dp, accum: int = 1) -> dict:
    """Training/prefill batch stand-ins (``shape``: ``SHAPES[name]``): int32
    tokens and labels, bf16 frames or image embeddings, the batch over
    ``dp``; with ``accum > 1`` a leading microbatch axis."""
    b, s = shape["global_batch"], shape["seq_len"]
    lead = (accum, b // accum) if accum > 1 else (b,)
    lead_spec = (None, dp) if accum > 1 else (dp,)
    out = {}
    if cfg.frontend == "frames":
        out["frames"] = sds((*lead, s, cfg.d_model), torch.bfloat16,
                            P(*lead_spec, None, None), mesh)
    else:
        out["tokens"] = sds((*lead, s), torch.int32, P(*lead_spec, None), mesh)
    out["labels"] = sds((*lead, s), torch.int32, P(*lead_spec, None), mesh)
    if cfg.n_img_tokens:
        out["image_embeds"] = sds((*lead, cfg.n_img_tokens, cfg.d_model), torch.bfloat16,
                                  P(*lead_spec, None, None), mesh)
    return out


def pick_accum(cfg: ModelConfig, shape: dict, n_dp: int, target_bytes: float = 2.5e9,
               n_tp: int = 1) -> int:
    """Gradient-accumulation factor keeping the activation footprint
    (microbatch x seq x d_model x 2 B x n_blocks per device) under
    ``target_bytes`` (the reference's rule; ``n_tp`` divides it for
    sequence-parallel activations)."""
    b, s = shape["global_batch"], shape["seq_len"]
    per_dev = max(b // n_dp, 1)
    accum = 1
    while accum < per_dev:
        mb = per_dev / accum
        footprint = mb * s * cfg.d_model * 2 * max(cfg.n_blocks, 1) / max(n_tp, 1)
        if footprint <= target_bytes:
            break
        accum *= 2
    # accum must divide the global batch and keep microbatch % n_dp == 0
    while accum > 1 and (b % accum or (b // accum) % n_dp):
        accum //= 2
    return accum


def analytic_model_flops(cfg: ModelConfig, shape: dict, kind: str) -> dict:
    """MODEL_FLOPS: 6 N D (train) or 2 N D (inference) with N the active
    parameters, plus the attention scores' FLOPs (the reference's
    arithmetic, float for float)."""
    b, s = shape["global_batch"], shape["seq_len"]
    n_active = cfg.active_param_count()
    dh = cfg.head_dim
    att = 0.0
    for spec in cfg.layers():
        if spec.mixer == "attn":
            eff = min(spec.window, s) if spec.window else s
            if kind == "decode":
                # one token attends over the cache
                att += 2 * 2 * b * cfg.n_heads * dh * eff
            else:
                avg_ctx = eff / 2 if spec.window is None else eff
                att += 2 * 2 * b * s * cfg.n_heads * dh * avg_ctx
        elif spec.mixer == "cross_attn":
            tq = 1 if kind == "decode" else s
            att += 2 * 2 * b * tq * cfg.n_heads * dh * cfg.n_img_tokens
    if kind == "train":
        tokens = b * s
        flops = 6.0 * n_active * tokens + 3.0 * att
    elif kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_active * tokens + att
    else:  # decode: one token per sequence
        tokens = b
        flops = 2.0 * n_active * tokens + att
    return {"model_flops": flops, "tokens": tokens, "active_params": n_active}
