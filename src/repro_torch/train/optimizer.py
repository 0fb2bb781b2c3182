"""AdamW with a choice of state dtype (float32 by default, bfloat16 for the
giant MoEs) and global-norm clipping (port of ``repro.train.optimizer``).

The reference's order of operations, leaf by leaf: the clip scale from the
global norm, the moments in float32 cast back to the state dtype, the
bias-corrected step in float32 cast back to the parameter dtype. Trees are
the port's parameter dicts (see :mod:`repro_torch.train.pytree`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.train.pytree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def adamw_init(params, state_dtype=torch.float32) -> AdamWState:
    """Zero moments in ``state_dtype`` (a torch dtype or its name) beside
    each parameter; the step counter on the first parameter's device."""
    dtype = _dtype(state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
):
    """``(new_params, new_state, grad_norm)``; ``grad_norm`` is the norm
    before clipping, ``lr`` a float or a float32 scalar tensor."""
    step = state.step + 1
    gnorm = global_norm(grads)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd_m(g, m):
        return (m.float() * b1 + g.float() * (1 - b1)).to(m.dtype)

    def upd_v(g, v):
        gf = g.float()
        return (v.float() * b2 + gf * gf * (1 - b2)).to(v.dtype)

    new_m = tree_map(upd_m, grads, state.m)
    new_v = tree_map(upd_v, grads, state.v)

    def upd_p(p, m, v):
        mhat = m.float() / c1
        vhat = v.float() / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_params = tree_map(upd_p, params, new_m, new_v)
    return new_params, AdamWState(step=step, m=new_m, v=new_v), gnorm
