"""Device meshes, sharding specs and placements (port of
``repro.launch.mesh``).

The reference names a tensor's sharding with a ``PartitionSpec``: one entry
per dim, ``None`` (whole), a mesh axis name, or a tuple of axis names (the
dim split over their product, the first axis major). The port keeps the
same specs in its own small type, :class:`P`, and places tensors with
``torch.distributed`` DTensors: :func:`placements` turns a spec into one
placement per mesh dim (``Shard(dim)`` on every axis that splits a tensor
dim, ``Replicate()`` on the others). A dim sharded over two axes (``("pod",
"data")``) is chunked over the first, then each chunk over the second, the
order JAX uses. Shards are always even: :func:`repro_torch.launch.specs.
sanitize_spec` replicates a dim that its axes do not divide.

The meshes are built over whatever process group exists, the dry run's fake
group of 256 or 512 ranks included, and the mesh's size must be the group's.
Nothing here touches ``torch.distributed`` at import time.

Sequence-parallel activations (``activation_partitioning="seq"``) split the
sequence over one mesh dim: :func:`stripe` is a rank's share of the
positions (DTensor's ``Shard`` rule, so any length splits, some stripes
shorter or empty), :func:`seq_gather` the differentiable all-gather of the
stripes (its backward reduce-scatters the summed gradient), and
:class:`Stripe` one rank's stripe with the gather, the slice and the global
last position.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["P", "Stripe", "axis_sizes", "batch_grad_placements", "gather", "gather_tree",
           "local_slice", "make_debug_mesh", "make_mesh", "make_production_mesh", "mesh_axes",
           "placements", "seq_gather", "shard", "shard_tree", "stripe"]


class P:
    """A sharding spec: one entry per tensor dim, each ``None``, an axis
    name, or a tuple of axis names. Not a tuple itself, so that the port's
    tree functions take a spec as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        for e in entries:
            if not (e is None or isinstance(e, str)
                    or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))):
                raise TypeError(f"a spec entry is None, an axis name or a tuple of names: {e!r}")
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self.entries)) + ")"


def entry_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry (none for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ------------------------------------------------------------------ meshes
def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over the default
    process group, whose size must be the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a process group of {n} "
                           f"ranks; none is initialised")
    if dist.get_world_size() != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The reference's production meshes: 16x16 ``(data, model)``, or
    2x16x16 ``(pod, data, model)``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type)


def mesh_axes(multi_pod: bool):
    """(the data axes the batch and the FSDP shards split over, the model
    axis) of the production meshes."""
    return (("pod", "data") if multi_pod else ("data",)), "model"


def make_debug_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A small ``(data, model)`` mesh over the ranks that exist (tests)."""
    return make_mesh((data, model), ("data", "model"), device_type)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of any object whose
    ``shape`` maps axis names to sizes (as the reference's tests fake one)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(s) for a, s in dict(mesh.shape).items()}


# -------------------------------------------------------------- placements
def placements(spec: P, mesh) -> tuple:
    """One DTensor placement per mesh dim for ``spec``: ``Shard(d)`` on each
    axis of entry ``d``, ``Replicate()`` on the axes no entry names. The
    axes of one entry must appear in the mesh's order (the major first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists its axes out of the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims in {spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def local_slice(full: torch.Tensor, places, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``places``: for each mesh dim in
    order, the coordinate's even chunk of its ``Shard`` dim (a view, no
    communication)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = full
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if out.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does not split evenly "
                                 f"over {n} ranks")
            step = out.shape[pl.dim] // n
            out = out.narrow(pl.dim, coord[i] * step, step)
    return out


def shard(full: torch.Tensor, spec: P, mesh):
    """A DTensor over ``mesh`` holding this rank's shard of ``full`` (the
    same tensor on every rank) as the sanitised ``spec`` places it, on the
    mesh's device type; no communication."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.specs import contiguous_stride, sanitize_spec

    places = placements(sanitize_spec(full.shape, spec, mesh), mesh)
    local = local_slice(full, places, mesh).to(mesh.device_type).contiguous()
    return DTensor.from_local(local, mesh, places, run_check=False, shape=full.shape,
                              stride=contiguous_stride(full.shape))


def shard_tree(tree, specs, mesh):
    """:func:`shard` over a tree and its tree of specs (the same structure,
    a :class:`P` at each leaf)."""
    from repro_torch.train.pytree import tree_map

    return tree_map(lambda t, s: shard(t, s, mesh), tree, specs)


def batch_grad_placements(mesh, batch_axes) -> tuple:
    """The placements of a gathered weight's gradient when the batch is
    split over ``batch_axes``: ``Partial()`` on those mesh dims (each rank's
    gradient is one part of the sum over the batch) and ``Replicate()`` on
    the others (their ranks computed the same gradient, which must not be
    summed again)."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if name in batch_axes else Replicate()
                 for name in mesh.mesh_dim_names)


def gather(t, grad_placements=None, device: torch.device | None = None):
    """The whole tensor of a DTensor on every rank (an all-gather over each
    mesh dim that shards it), on ``device``; a plain tensor comes through.
    ``grad_placements`` say how the gradient of the gathered tensor is to be
    read on the way back (:func:`batch_grad_placements`); without them
    DTensor takes it as replicated, which is wrong when the batch is split."""
    return gather_tree([t], grad_placements, device)[0]


def gather_tree(tree, grad_placements=None, device=None):
    """Every DTensor leaf of ``tree`` gathered whole (with no arguments, the
    whole tensors a checkpoint writes), on ``device``; plain leaves come
    through.

    The leaves are gathered in groups, one collective per mesh dim for each
    set of leaves that share a dtype and the mesh dims that shard them: each
    rank's shards of a group flattened into one row, the rows all-gathered
    as one DTensor (``Shard(0)`` on those mesh dims) and each leaf put back
    together from its columns. The bytes are those of gathering each leaf
    on its own, in a few large collectives in place of one or two a leaf;
    the gradient takes the same way back (one reduce-scatter, or all-reduce
    for replicated leaves, a group and mesh dim)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.specs import contiguous_stride
    from repro_torch.train.pytree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    out = list(leaves)
    groups: dict = {}
    for i, t in enumerate(leaves):
        if isinstance(t, DTensor):
            key = (t.device_mesh, tuple(isinstance(pl, Shard) for pl in t.placements), t.dtype)
            groups.setdefault(key, []).append(i)
    for (mesh, split, _), idx in groups.items():
        locals_ = [leaves[i].to_local() for i in idx]
        flat = torch.cat([loc.reshape(-1) for loc in locals_])[None]
        rows_n = math.prod(mesh.size(d) for d, s in enumerate(split) if s)
        places = tuple(Shard(0) if s else Replicate() for s in split)
        grid = DTensor.from_local(flat, mesh, places, run_check=False,
                                  shape=(rows_n, flat.shape[1]),
                                  stride=contiguous_stride((rows_n, flat.shape[1])))
        rows = grid.full_tensor(grad_placements=grad_placements)
        lo = 0
        for i, loc in zip(idx, locals_):
            t, n = leaves[i], loc.numel()
            sizes = [mesh.size(d) for d, pl in enumerate(t.placements) if isinstance(pl, Shard)]
            out[i] = _unshard(rows[:, lo:lo + n], t.placements, sizes, loc.shape, t.shape)
            lo += n
    if device is not None:
        out = [t.to(device) if isinstance(t, torch.Tensor) and t.device != device else t
               for t in out]
    return tree_unflatten(treedef, out)


def _unshard(rows: torch.Tensor, places, sizes, local_shape, shape) -> torch.Tensor:
    """The tensor of ``shape`` from its shards, one a row of ``rows`` in the
    order DTensor chunks ``Shard(0)`` over the mesh dims that shard it (the
    first mesh dim major; ``sizes`` theirs): the rows viewed as
    ``[*sizes, *local_shape]``, each mesh axis moved in front of the tensor
    dim it splits, and the result flattened to ``shape``."""
    from torch.distributed.tensor import Shard

    dims = [pl.dim for pl in places if isinstance(pl, Shard)]
    k = len(dims)
    order = []
    for d in range(len(local_shape)):
        order += [a for a, dim in enumerate(dims) if dim == d] + [k + d]
    return rows.reshape(*sizes, *local_shape).permute(*order).reshape(shape)


# ------------------------------------------------------- sequence stripes
def stripe(total: int, n: int, r: int) -> tuple[int, int]:
    """``(start, length)`` of rank ``r``'s stripe when ``total`` positions
    split over ``n`` ranks by DTensor's ``Shard`` rule: chunks of
    ``ceil(total / n)`` in rank order, so the last stripes may be shorter
    or empty."""
    size = -(-total // n)
    start = min(r * size, total)
    return start, min(size, total - start)


def _dim_placements(mesh, i: int, on_dim, off_dim) -> tuple:
    return tuple(on_dim if j == i else off_dim for j in range(len(mesh.mesh_dim_names)))


def seq_gather(x: torch.Tensor, mesh, dim_name: str, seq_dim: int, total: int) -> torch.Tensor:
    """The whole sequence (``total`` positions) of the stripes ``x`` that the
    ranks of mesh dim ``dim_name`` hold along ``seq_dim``, on ``x``'s
    device: an all-gather, whose backward reduce-scatters the gradient
    summed over those ranks (each rank's gradient of the whole sequence is
    one part of the sum). Ranks of the other mesh dims gather their own
    stripes apart. A host mesh's collectives run on the host."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.specs import contiguous_stride

    i = mesh.mesh_dim_names.index(dim_name)
    if mesh.size(i) == 1:
        return x
    shape = list(x.shape)
    shape[seq_dim] = total
    dt = DTensor.from_local(x.contiguous(), mesh, _dim_placements(mesh, i, Shard(seq_dim),
                                                                  Replicate()),
                            run_check=False, shape=torch.Size(shape),
                            stride=contiguous_stride(shape))
    out = dt.full_tensor(grad_placements=_dim_placements(mesh, i, Partial(), Replicate()))
    return out.to(x.device) if out.device != x.device else out


@dataclasses.dataclass(frozen=True)
class Stripe:
    """This rank's stripe of a sequence of ``total`` positions split over
    the mesh dim ``dim_name``: positions ``start .. start + length - 1``
    (``ranks`` the dim's size)."""

    mesh: object
    dim_name: str
    total: int
    start: int
    length: int
    ranks: int

    @classmethod
    def of(cls, mesh, dim_name: str, total: int) -> "Stripe":
        i = mesh.mesh_dim_names.index(dim_name)
        n = mesh.size(i)
        start, length = stripe(total, n, mesh.get_coordinate()[i])
        return cls(mesh, dim_name, total, start, length, n)

    def gather(self, x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        """:func:`seq_gather` of this stripe's ``x``."""
        return seq_gather(x, self.mesh, self.dim_name, seq_dim, self.total)

    def keep(self, x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        """This stripe of the whole sequence ``x`` (a view)."""
        return x.narrow(seq_dim, self.start, self.length)

    def last(self, x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        """The sequence's last position (``total - 1``) of the stripes ``x``,
        on every rank of the dim: the rank that holds it sends it, the
        others zeros, summed (an all-reduce, exact)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        if self.total == 0:
            raise ValueError("an empty sequence has no last position")
        if self.start + self.length == self.total and self.length:
            row = x.narrow(seq_dim, self.length - 1, 1)
        else:
            shape = list(x.shape)
            shape[seq_dim] = 1
            row = x.new_zeros(shape)
        i = self.mesh.mesh_dim_names.index(self.dim_name)
        dt = DTensor.from_local(row.contiguous(), self.mesh,
                                _dim_placements(self.mesh, i, Partial(), Replicate()),
                                run_check=False)
        out = dt.full_tensor()
        return out.to(x.device) if out.device != x.device else out
