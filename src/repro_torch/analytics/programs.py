"""Vertex programs as (init, message, combine, apply) semirings (port of
``repro.analytics.programs``).

All three paper workloads share one gather-apply skeleton:

    msgs_e   = message(state[col_e], deg[col_e])
    agg_v    = combine-reduce over edges with row == v
    state_v' = apply(state_v, agg_v, ctx)

``message`` and ``apply`` act on float32 torch tensors, elementwise, so the
engine may apply ``message`` to a whole state vector before the gather and
get the same bits; ``init`` builds numpy arrays, as in the reference. The
float64 ``reference_*`` functions are numpy copies of the reference's dense
oracles.

The three programs are built from module-level functions (parameters bound
with ``functools.partial``), so they pickle: the sharded engine ships them
to its worker processes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

__all__ = [
    "PROGRAMS",
    "VertexProgram",
    "cc_program",
    "pagerank_program",
    "reference_cc",
    "reference_pagerank",
    "reference_sssp",
    "sssp_program",
]


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    name: str
    identity: float  # identity of the combine reduction
    reduce_kind: str  # "sum" | "min"
    init: Callable  # (local_to_global, local_count, ctx) -> float32[v_max]
    message: Callable  # (src_state, src_deg) -> msg
    apply: Callable  # (old_state, agg, ctx) -> new_state

    def init_state(self, lg, ctx) -> np.ndarray:
        return np.stack(
            [
                self.init(lg.local_to_global[p], int(lg.local_count[p]), ctx)
                for p in range(lg.k)
            ]
        )


def _pagerank_init(l2g, count, ctx):
    n = ctx["num_vertices"]
    x = np.full(l2g.shape[0], 1.0 / n, dtype=np.float32)
    x[count:] = 0.0
    return x


def _pagerank_message(src_state, src_deg):
    return src_state / torch.clamp(src_deg, min=1.0)


def _pagerank_apply(damping, old, agg, ctx):
    n = ctx["num_vertices"]
    return (1.0 - damping) / n + damping * agg


def pagerank_program(damping: float = 0.85) -> VertexProgram:
    return VertexProgram(
        name="pagerank", identity=0.0, reduce_kind="sum", init=_pagerank_init,
        message=_pagerank_message, apply=functools.partial(_pagerank_apply, damping),
    )


_INF = np.float32(3.0e38)


def _cc_init(l2g, count, ctx):
    x = l2g.astype(np.float32).copy()
    x[count:] = _INF
    return x


def _identity_message(src_state, src_deg):
    return src_state


def _min_apply(old, agg, ctx):
    return torch.minimum(old, agg)


def cc_program() -> VertexProgram:
    """Connected components via label propagation (labels = vertex ids)."""
    return VertexProgram(
        name="cc", identity=float(_INF), reduce_kind="min",
        init=_cc_init, message=_identity_message, apply=_min_apply,
    )


def _sssp_init(source, l2g, count, ctx):
    x = np.full(l2g.shape[0], _INF, dtype=np.float32)
    x[np.flatnonzero(l2g == source)] = 0.0
    return x


def _sssp_message(src_state, src_deg):
    return src_state + 1.0


def sssp_program(source: int = 0) -> VertexProgram:
    """Single-source shortest path, unit weights (Bellman-Ford)."""
    return VertexProgram(
        name="sssp", identity=float(_INF), reduce_kind="min",
        init=functools.partial(_sssp_init, source), message=_sssp_message, apply=_min_apply,
    )


PROGRAMS = {
    "pagerank": pagerank_program,
    "cc": cc_program,
    "sssp": sssp_program,
}


# ----------------------------------------------------------- dense references
def reference_pagerank(graph, iters: int, damping: float = 0.85) -> np.ndarray:
    n = graph.num_vertices
    x = np.full(n, 1.0 / n, dtype=np.float64)
    deg = np.maximum(graph.degrees, 1).astype(np.float64)
    src = np.repeat(np.arange(n), graph.degrees)
    dst = graph.indices
    for _ in range(iters):
        contrib = x[dst] / deg[dst]
        agg = np.zeros(n)
        np.add.at(agg, src, contrib)
        x = (1 - damping) / n + damping * agg
    return x


def reference_cc(graph, iters: int) -> np.ndarray:
    n = graph.num_vertices
    x = np.arange(n, dtype=np.float64)
    src = np.repeat(np.arange(n), graph.degrees)
    dst = graph.indices
    for _ in range(iters):
        agg = np.full(n, np.inf)
        np.minimum.at(agg, src, x[dst])
        x = np.minimum(x, agg)
    return x


def reference_sssp(graph, iters: int, source: int = 0) -> np.ndarray:
    n = graph.num_vertices
    x = np.full(n, np.inf)
    x[source] = 0.0
    src = np.repeat(np.arange(n), graph.degrees)
    dst = graph.indices
    for _ in range(iters):
        agg = np.full(n, np.inf)
        np.minimum.at(agg, src, x[dst] + 1.0)
        x = np.minimum(x, agg)
    return x
