"""Op-level cost analysis of one call: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference compiles its step and parses the HLO text: it sums ``2 *
prod(result dims) * prod(contracting dims)`` over every dot and the result
bytes of every collective, each times the trip count of the ``while`` loop
it sits in (XLA's own cost analysis counts a loop body once). The port
compiles nothing: it runs the step once, eagerly, and counts what runs. So
:func:`analyze` calls ``fn(*args)`` under :class:`OpCounter`, a
``TorchDispatchMode`` that adds up the FLOPs of every op that
``torch.utils.flop_counter`` has a formula for (its ``flop_registry``: the
matmuls, batched matmuls, convolutions and fused attentions, in the forward
and the backward) and reads the result bytes of every
``_c10d_functional`` (and ``c10d``) collective: the all-gathers and
reduce-scatters DTensor runs, the all-reduces of the loss and the norm.
CommDebugMode counts calls only, which is why the bytes are read here;
``FlopCounterMode`` gives the same FLOPs but also tracks modules, which
under fake tensors made a step about four times slower.

Under a ``FakeTensorMode`` on a fake process group (the dry run) the same
call allocates nothing and communicates nothing, at any width and rank
count. The layers run as a Python loop, so every count is already a total;
there is no loop multiplier to recover, and ``max_trip_count`` is the
caller's number of layer repeats (the reference's scan length), or, if not
given, the most times one dot of one signature ran (a loop of 5 identical
matmuls gives 5). The one loop a caller may trace once is a train step's
gradient accumulation: ``make_train_step(..., sample=counter.repeat)``
runs its first microbatch under :meth:`OpCounter.repeat` ``(accum)``, the
others being the same ops on the same shapes.

The counts are per shard: what this rank runs. The kernels cannot launch on
fake tensors, so a dry run counts the plain versions' products (the
attention's score and value products among them, as the reference's HLO
counts its attention dots): a rank's query heads against all the keys
count ``Tq x Tk`` scores each, the masked ones included, as the
reference's dense ``_sdpa`` does. The model axis's collectives
(``launch.mesh.ModelAxis``: the row-parallel all-reduces, the stripes'
gathers and reduce-scatters, the K/V gathers) are functional collectives
like DTensor's, counted the same way (``launch/mesh.py`` is plumbing: the
source named is the model code that asked).
"""
from __future__ import annotations

import collections
import contextlib
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["COLLECTIVE_OPS", "OpCounter", "analyze"]

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute", "broadcast")

# op name (``_c10d_functional`` or ``c10d``) -> the reference's HLO name
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


# the port's own plumbing, skipped when naming where a collective came from
_PLUMBING = ("/launch/op_analysis.py", "/launch/mesh.py", "/train/pytree.py")


def _source() -> str:
    """The innermost frame of the port's model or train code that led to
    the current op (``file:line function``)."""
    for frame in reversed(traceback.extract_stack()[:-3]):
        name = frame.filename.replace("\\", "/")
        if "repro_torch/" in name and not name.endswith(_PLUMBING):
            return f"{name.split('repro_torch/', 1)[1]}:{frame.lineno} {frame.name}"
    return "?"


class OpCounter(TorchDispatchMode):
    """Counts what runs under it: ``flops`` (the ``flop_registry``
    formulas), ``dots`` ((op, input shapes) -> calls, for each op with a
    formula) and ``records``, one ``(kind, result bytes, result shapes,
    source, times)`` per collective (``source`` only when ``sources`` is
    set; ``times`` the :meth:`repeat` factor it ran under)."""

    def __init__(self, sources: bool = False):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self.sources = sources
        self.registry = flop_registry
        self.scale = 1
        self.flops = 0
        self.records: list[tuple] = []
        self.dots: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += self.scale * formula(*args, **kwargs, out_val=out)
            sig = (func._overloadpacket.__name__,
                   tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)))
            self.dots[sig] += self.scale
            return out
        ns = func.namespace
        name = func._schema.name.split("::", 1)[-1]
        if ns in ("_c10d_functional", "c10d_functional", "c10d") and name in _KINDS:
            result = out[0] if ns == "c10d" and isinstance(out, tuple) else out
            shapes = [tuple(t.shape) for t in (result if isinstance(result, (list, tuple))
                                               else [result]) if isinstance(t, torch.Tensor)]
            self.records.append((_KINDS[name], _nbytes(result), shapes,
                                 _source() if self.sources else None, self.scale))
        return out

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside as ``n`` runs of it: a loop body that is
        traced once and stands for ``n`` identical iterations, as the
        reference multiplies a ``while`` body by its trip count."""
        saved, self.scale = self.scale, self.scale * int(n)
        try:
            yield
        finally:
            self.scale = saved

    def summary(self) -> dict:
        per_op: dict = collections.defaultdict(float)
        counts: dict = collections.defaultdict(int)
        for kind, nbytes, _, _, times in self.records:
            per_op[kind] += nbytes * times
            counts[kind] += times
        return {"collective_bytes": dict(per_op), "collective_counts": dict(counts),
                "total_collective_bytes": float(sum(per_op.values()))}


def analyze(fn, *args, trip_count: int | None = None, sources: bool = False,
            counter: OpCounter | None = None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count it: the reference's keys
    ``dot_flops_per_shard``, ``collective_bytes`` and ``collective_counts``
    (by the reference's op names), ``total_collective_bytes``,
    ``max_trip_count``, and ``result`` (what ``fn`` returned) and
    ``counter`` (the :class:`OpCounter`, its records and dots; pass one to
    let ``fn`` use its :meth:`~OpCounter.repeat`)."""
    counter = counter or OpCounter(sources=sources)
    with counter:
        result = fn(*args, **kwargs)
    out = counter.summary()
    out["dot_flops_per_shard"] = float(counter.flops)
    if trip_count is None:
        trip_count = max(counter.dots.values(), default=1)
    out["max_trip_count"] = float(trip_count)
    out["result"] = result
    out["counter"] = counter
    return out
