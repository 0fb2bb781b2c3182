"""Carry state from plain arrays into the port.

The reference package's graphs, partition states and model parameters are
(or convert to) numpy arrays; these functions build the port's counterparts
from such arrays, so a caller can run both packages on the same data without
the port importing the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analytics.localize import LocalizedGraph
from repro_torch.core.base import PartitionState
from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph

__all__ = [
    "graph_from_arrays",
    "lm_params_from_arrays",
    "lm_params_to_reference",
    "localized_from_arrays",
    "stack_layers",
    "stacked_spec",
    "state_from_arrays",
]


def graph_from_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    device: str | torch.device | None = None,
) -> CSRGraph:
    """A :class:`CSRGraph` over copies of ``indptr`` (int64) and ``indices``
    (int32), with its arrays also placed on ``device``."""
    indptr = np.array(indptr, dtype=np.int64)
    indices = np.array(indices, dtype=np.int32)
    if indptr.ndim != 1 or indptr.shape[0] < 1 or indices.ndim != 1:
        raise ValueError("indptr and indices must be 1-D, indptr non-empty")
    if indptr[0] != 0 or indptr[-1] != indices.shape[0] or (np.diff(indptr) < 0).any():
        raise ValueError("indptr must rise from 0 to len(indices)")
    if indices.size and (indices.min() < 0 or indices.max() >= indptr.shape[0] - 1):
        raise ValueError("indices must be vertex ids in [0, |V|)")
    graph = CSRGraph(indptr=indptr, indices=indices)
    graph.to(resolve_device(device))
    return graph


def state_from_arrays(
    part_of: np.ndarray,
    v_counts: np.ndarray,
    e_counts: np.ndarray,
    *,
    k: int,
    epsilon: float,
    balance_mode: str,
    seed: int,
    total_degree: int,
    device: str | torch.device | None = None,
) -> PartitionState:
    """A :class:`PartitionState` holding copies of the arrays, with its
    ``part_of`` mirror on ``device`` and a fresh ``default_rng(seed)``
    tie-break generator."""
    part_of = np.asarray(part_of)
    if part_of.ndim != 1 or (part_of.size and (part_of.min() < -1 or part_of.max() >= k)):
        raise ValueError("part_of must be 1-D with ids in [-1, k)")
    if np.shape(v_counts) != (k,) or np.shape(e_counts) != (k,):
        raise ValueError(f"v_counts and e_counts must have shape ({k},)")
    return PartitionState.from_arrays(
        part_of,
        v_counts,
        e_counts,
        k=k,
        total_degree=total_degree,
        epsilon=epsilon,
        balance_mode=balance_mode,
        seed=seed,
        device=resolve_device(device),
    )


def localized_from_arrays(
    *,
    k: int,
    v_max: int,
    h_max: int,
    e_max: int,
    num_vertices: int,
    num_edges: int,
    local_to_global: np.ndarray,
    local_count: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    send_gather: np.ndarray,
    send_count: np.ndarray,
    degrees_full: np.ndarray,
    local_degrees: np.ndarray,
    part: np.ndarray,
    global_to_local: np.ndarray,
) -> LocalizedGraph:
    """A :class:`LocalizedGraph` over copies of a layout's arrays (the fields
    of the reference's ``LocalizedGraph``, e.g. ``**dataclasses.asdict(lg)``),
    so both engines can run on one layout. Checks the shapes, the index
    ranges the engine relies on, and that each device's ``rows`` are in CSR
    order."""
    k, v_max, h_max, e_max = int(k), int(v_max), int(h_max), int(e_max)
    state_len = v_max + k * h_max + 1
    arrays = {
        "local_to_global": (local_to_global, np.int32, (k, v_max)),
        "local_count": (local_count, np.int32, (k,)),
        "rows": (rows, np.int32, (k, e_max)),
        "cols": (cols, np.int32, (k, e_max)),
        "send_gather": (send_gather, np.int32, (k, k, h_max)),
        "send_count": (send_count, np.int32, (k, k)),
        "degrees_full": (degrees_full, np.float32, (k, state_len)),
        "local_degrees": (local_degrees, np.float32, (k, v_max)),
        "part": (part, np.int32, (int(num_vertices),)),
        "global_to_local": (global_to_local, np.int32, (int(num_vertices),)),
    }
    out = {}
    for name, (arr, dtype, shape) in arrays.items():
        arr = np.array(arr, dtype=dtype)
        if arr.shape != shape:
            raise ValueError(f"{name} has shape {arr.shape}, expected {shape}")
        out[name] = arr
    if out["cols"].size and (out["cols"].min() < 0 or out["cols"].max() >= state_len):
        raise ValueError(f"cols must index the state vector [0, {state_len})")
    if out["send_gather"].size and (
        out["send_gather"].min() < 0 or out["send_gather"].max() >= v_max
    ):
        raise ValueError(f"send_gather must hold local indices in [0, {v_max})")
    lg = LocalizedGraph(
        k=k, v_max=v_max, h_max=h_max, e_max=e_max,
        num_vertices=int(num_vertices), num_edges=int(num_edges), **out,
    )
    lg.row_ptr()  # raises unless rows are in CSR order
    return lg


def _tensor(arr, device: torch.device) -> torch.Tensor:
    """A tensor copy of a numpy array (or a tensor on ``device``); bfloat16
    arrays (the reference's ``ml_dtypes`` type) keep their bits."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_arrays(cfg, params: dict, device: str | torch.device | None = None) -> dict:
    """The port's parameter dict (``Model.init``'s layout) from the
    reference's parameter pytree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) or tensors (a restored checkpoint): the ``prefix`` layers (a
    tuple of per-layer dicts) come first, then ``blocks``, whose leaves
    carry a leading ``n_blocks`` axis, unstacked into one dict per layer, in
    ``cfg.layers()`` order, so both packages compute with the same weights.
    Nested leaves come along as they are: an MoE layer's ``moe`` dict (the
    float32 ``router`` ``[D, E]``, ``w_in``/``w_gate`` ``[E, D, F]``,
    ``w_out`` ``[E, F, D]`` and a ``shared`` dense FFN) keeps its dtypes, a
    cross-attention layer its ``gate``, an MLA layer its ``wq_a``,
    ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b`` and ``wo``. A
    frame-input model's tree has no ``embed``."""
    device = resolve_device(device)
    prefix = tuple(params.get("prefix", ()))
    if len(prefix) != len(cfg.prefix):
        raise ValueError(f"params hold {len(prefix)} prefix layers, cfg has {len(cfg.prefix)}")
    blocks = params["blocks"]
    if len(blocks) != len(cfg.block):
        raise ValueError(f"params hold {len(blocks)} block layers, cfg has {len(cfg.block)}")
    layers = [_tree(p, lambda a: _tensor(a, device)) for p in prefix] + [
        _tree(blocks[j], lambda a, i=i: _tensor(a[i], device))
        for i in range(cfg.n_blocks)
        for j in range(len(cfg.block))
    ]
    out = {}
    if "embed" in params:
        out["embed"] = _tensor(params["embed"], device)
    out["layers"] = layers
    out["final_norm"] = _tree(params["final_norm"], lambda a: _tensor(a, device))
    if "unembed" in params:
        out["unembed"] = _tensor(params["unembed"], device)
    return out


def stack_layers(cfg, layers: list, stack=None) -> tuple[tuple, tuple]:
    """``(prefix, blocks)`` of a per-layer list in ``cfg.layers()`` order:
    the first ``len(cfg.prefix)`` layers as they are, then the layers of
    each ``cfg.block`` position stacked over the ``n_blocks`` repeats with
    ``stack`` (a list of leaves -> one leaf; ``torch.stack`` by default, or
    :func:`stacked_spec` for a tree of sharding specs)."""
    stack = stack or torch.stack
    n_prefix, width = len(cfg.prefix), len(cfg.block)
    if len(layers) != n_prefix + cfg.n_blocks * width:
        raise ValueError(f"params hold {len(layers)} layers, cfg has "
                         f"{n_prefix + cfg.n_blocks * width}")
    prefix, rest = layers[:n_prefix], layers[n_prefix:]

    def stacked(group: list):
        if isinstance(group[0], dict):
            return {key: stacked([g[key] for g in group]) for key in group[0]}
        return stack(group)

    return tuple(prefix), tuple(stacked(rest[j::width]) for j in range(width))


def stacked_spec(group: list):
    """The spec of a leaf stacked over the blocks: the reference's ``P(None,
    *spec)`` (a leading, unsharded ``n_blocks`` dim)."""
    from repro_torch.launch.mesh import P

    return P(None, *group[0])


def lm_params_to_reference(cfg, params: dict, stack=None) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the port's parameter
    dict (or a tree of the same layout, such as AdamW's moments or
    ``Model.param_specs()`` with ``stack=stacked_spec``) in the reference's
    layout, ``{"blocks", "embed", "final_norm", "prefix", "unembed"}``: the
    first ``len(cfg.prefix)`` layers as the ``prefix`` tuple of per-layer
    dicts, the rest with the layers of each ``cfg.block`` position stacked
    on a leading ``n_blocks`` axis (:func:`stack_layers`), on the
    parameters' device (no ``embed`` for a frame-input model). Flattened in
    JAX's leaf order (:mod:`repro_torch.train.pytree`) it gives the
    reference's leaves one by one (an MoE layer's ``moe`` leaves too, as
    ``[n_blocks, E, ...]``), which is what lets checkpoints cross."""
    prefix, blocks = stack_layers(cfg, params["layers"], stack)
    out = {"blocks": blocks}
    if "embed" in params:
        out["embed"] = params["embed"]
    out["final_norm"] = params["final_norm"]
    out["prefix"] = prefix
    if "unembed" in params:
        out["unembed"] = params["unembed"]
    return out
