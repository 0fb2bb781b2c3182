"""AdamW with a choice of state dtype (float32 by default, bfloat16 for the
giant MoEs) and global-norm clipping (port of ``repro.train.optimizer``).

The reference's order of operations, leaf by leaf: the clip scale from the
global norm, the moments in float32 cast back to the state dtype, the
bias-corrected step in float32 cast back to the parameter dtype. Trees are
the port's parameter dicts (see :mod:`repro_torch.train.pytree`).

On a mesh the parameters, gradients and moments are DTensors of the same
placements (``adamw_state_specs``: the state inherits the parameters'
specs, so the moments are FSDP-sharded as their parameters are). The update
is elementwise and runs on each rank's shards; the global norm is the norm
of the whole gradient: each shard's sum of squares counted once (by the
ranks at coordinate 0 of the axes that replicate it) and summed over the
ranks in one all-reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.train.pytree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_state_specs", "adamw_update", "global_norm"]


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
    zeros = lambda p: torch.zeros_like(p, dtype=dtype)  # noqa: E731  (a DTensor's too)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def adamw_state_specs(param_specs) -> AdamWState:
    """The state's sharding specs: the step replicated, each moment placed
    as its parameter."""
    from repro_torch.launch.mesh import P

    return AdamWState(step=P(), m=param_specs, v=param_specs)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _owned_sum_sq(x) -> torch.Tensor:
    """A DTensor shard's float32 sum of squares where this rank owns it
    (coordinate 0 on every mesh dim that does not shard the tensor), else
    zero."""
    from torch.distributed.tensor import Shard

    coord = x.device_mesh.get_coordinate()
    owner = all(isinstance(pl, Shard) or c == 0 for pl, c in zip(x.placements, coord))
    local = x.to_local().float()
    return torch.sum(torch.square(local)) if owner else local.new_zeros(())


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every leaf, as a float32 scalar (plain tensor); of a
    tree of DTensors, the norm of the whole tensors on every rank."""
    leaves = tree_leaves(tree)
    if leaves and _is_dtensor(leaves[0]):
        import torch.distributed.distributed_c10d as c10d
        from torch.distributed import _functional_collectives as funcol

        sums = torch.stack([_owned_sum_sq(x) for x in leaves])
        sums = funcol.all_reduce(sums, "sum", c10d._get_default_group())  # the mesh's ranks
        return torch.sqrt(torch.sum(sums))
    leaves = [torch.sum(torch.square(x.float())) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _map_shards(fn, tree, *rest):
    """``fn`` over the leaves of trees of the same structure; where they are
    DTensors, over their local shards, the result placed as the first."""
    from torch.distributed.tensor import DTensor

    def one(t, *others):
        if not isinstance(t, DTensor):
            return fn(t, *others)
        out = fn(t.to_local(), *(o.to_local() for o in others))
        return DTensor.from_local(out, t.device_mesh, t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tree_map(one, tree, *rest)


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
        grads = _map_shards(lambda g: g * scale.to(g.device, g.dtype), grads)
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd_m(g, m):
        return (m.float() * b1 + g.float() * (1 - b1)).to(m.dtype)

    def upd_v(g, v):
        gf = g.float()
        return (v.float() * b2 + gf * gf * (1 - b2)).to(v.dtype)

    new_m = _map_shards(upd_m, grads, state.m)
    new_v = _map_shards(upd_v, grads, state.v)

    def upd_p(p, m, v):
        mhat = m.float() / c1
        vhat = v.float() / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_params = _map_shards(upd_p, params, new_m, new_v)
    return new_params, AdamWState(step=step, m=new_m, v=new_v), gnorm
