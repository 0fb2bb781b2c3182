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
shorter or empty), and :class:`Stripe` one rank's stripe with the
differentiable all-gather of the stripes (its backward reduce-scatters the
summed gradient), the reduce-scatter back to the stripes and the slice.

Tensor-parallel products (a model axis above 1, in both modes): a weight
whose spec splits a dim over the model axis stays split over it, gathered
over the data axes only (:func:`gather_tree` with ``keep``), and
:class:`ModelAxis` carries the collectives between a rank's column- and
row-parallel products, each a ``torch.autograd.Function`` over the
functional collectives of the model axis's group: the sum of a row-parallel
product's partial outputs (backward the identity), the copy of a region's
input (backward the sum of the ranks' partial gradients), the all-gather of
a column-parallel product's chunks (backward a reduce-scatter), the same
at a sequence's stripes, and the channel exchange of a concatenated weight.
A model axis of one rank, and a region whose weights the specs leave whole,
is a :class:`ModelAxis` too, whose ``enter`` and ``exit`` pass the
activations through (under ``"seq"``: gather the stripes, keep its own).
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ModelAxis", "P", "Stripe", "axis_sizes", "batch_grad_placements", "gather",
           "gather_tree", "local_slice", "make_debug_mesh", "make_mesh", "make_production_mesh",
           "mesh_axes", "placements", "shard", "shard_tree", "stripe"]


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


def gather_tree(tree, grad_placements=None, device=None, keep=()):
    """Every DTensor leaf of ``tree`` gathered whole (with no arguments, the
    whole tensors a checkpoint writes), on ``device``; plain leaves come
    through. ``keep`` names mesh dims whose shards stay put: a leaf split
    over one comes back as this rank's chunk along it, gathered over the
    others only (a tensor-parallel weight gathered over the data axes).

    The leaves are gathered in groups, one collective per mesh dim for each
    set of leaves that share a dtype and the mesh dims that shard them: each
    rank's shards of a group flattened into one row, the rows all-gathered
    as one DTensor (``Shard(0)`` on those mesh dims) and each leaf put back
    together from its columns. The bytes are those of gathering each leaf
    on its own, in a few large collectives in place of one or two a leaf;
    the gradient takes the same way back (one reduce-scatter, or all-reduce
    for replicated leaves, a group and mesh dim). A kept mesh dim is
    ``Replicate`` in the group's DTensor: its ranks hold different chunks,
    which the gather over the other dims never mixes, and ``grad_placements``
    should leave it ``Replicate`` too (each rank's gradient is its chunk's)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.specs import contiguous_stride
    from repro_torch.train.pytree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    out = list(leaves)
    groups: dict = {}
    for i, t in enumerate(leaves):
        if isinstance(t, DTensor):
            names = t.device_mesh.mesh_dim_names
            split = tuple(isinstance(pl, Shard) and names[d] not in keep
                          for d, pl in enumerate(t.placements))
            groups.setdefault((t.device_mesh, split, t.dtype), []).append(i)
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
            gathered = [pl if s else Replicate() for pl, s in zip(t.placements, split)]
            sizes = [mesh.size(d) for d, pl in enumerate(gathered) if isinstance(pl, Shard)]
            shape = list(loc.shape)
            for d, pl in enumerate(gathered):
                if isinstance(pl, Shard):
                    shape[pl.dim] *= mesh.size(d)
            out[i] = _unshard(rows[:, lo:lo + n], gathered, sizes, loc.shape, shape)
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


def _axis_group(mesh, dim_name: str) -> tuple:
    """The functional collectives' name for the ranks of mesh dim
    ``dim_name`` that share this rank's other coordinates."""
    return (mesh, mesh.mesh_dim_names.index(dim_name))


def _collective(op: str, t: torch.Tensor, group: tuple, *args) -> torch.Tensor:
    """``torch.ops._c10d_functional.<op>(t, *args, group size?, group name)``
    on the device the group's collectives run on (a host mesh's on the
    host), waited for, its result back on ``t``'s device."""
    mesh, i = group
    src = t if t.device.type == mesh.device_type else t.to(mesh.device_type)
    name = mesh.get_group(i).group_name
    fn = getattr(torch.ops._c10d_functional, op)
    sized = () if op in ("all_reduce", "all_to_all_single") else (mesh.size(i),)
    out = torch.ops._c10d_functional.wait_tensor(fn(src.contiguous(), *args, *sized, name))
    return out.to(t.device) if out.device != t.device else out


def _all_reduce(t: torch.Tensor, group: tuple, op: str = "sum") -> torch.Tensor:
    return _collective("all_reduce", t, group, op)


def _all_gather(t: torch.Tensor, dim: int, group: tuple) -> torch.Tensor:
    """The ranks' equal chunks ``t`` concatenated along ``dim`` in rank order."""
    dim %= t.dim()
    out = _collective("all_gather_into_tensor", t.movedim(dim, 0), group)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, group: tuple) -> torch.Tensor:
    """This rank's equal chunk along ``dim`` of the sum of the ranks' ``t``."""
    dim %= t.dim()
    out = _collective("reduce_scatter_tensor", t.movedim(dim, 0), group, "sum")
    return out.movedim(0, dim)


def _pad(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to ``length``."""
    extra = length - x.shape[dim]
    if extra == 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim)


class _StripeGather(torch.autograd.Function):
    """The stripes of a sequence all-gathered whole along ``dim`` (each
    padded to the longest stripe, the padding cut off). Backward: the
    stripe of the sum of the ranks' gradients (a reduce-scatter) where
    ``partial`` (each rank's use of the whole sequence is a part of the
    loss), else this rank's stripe of its own gradient (every rank used the
    whole sequence alike)."""

    @staticmethod
    def forward(ctx, x, s, dim, partial):
        ctx.s, ctx.dim, ctx.partial = s, dim, partial
        size = -(-s.total // s.ranks)
        whole = _all_gather(_pad(x, dim, size), dim, _axis_group(s.mesh, s.dim_name))
        return whole.narrow(dim, 0, s.total)

    @staticmethod
    def backward(ctx, g):
        s, dim = ctx.s, ctx.dim
        if not ctx.partial:
            return g.narrow(dim, s.start, s.length), None, None, None
        size = -(-s.total // s.ranks)
        part = _reduce_scatter(_pad(g, dim, size * s.ranks), dim, _axis_group(s.mesh, s.dim_name))
        return part.narrow(dim, 0, s.length), None, None, None


class _StripeScatter(torch.autograd.Function):
    """This rank's stripe along ``dim`` of a whole sequence: of the sum of
    the ranks' partial ``y`` (a reduce-scatter) where ``summed``, else of
    its own ``y`` (the same on every rank). Backward: the stripes'
    gradients all-gathered, the whole sequence's gradient on every rank."""

    @staticmethod
    def forward(ctx, y, s, dim, summed):
        ctx.s, ctx.dim = s, dim
        if not summed:
            return y.narrow(dim, s.start, s.length).clone()
        size = -(-s.total // s.ranks)
        part = _reduce_scatter(_pad(y, dim, size * s.ranks), dim, _axis_group(s.mesh, s.dim_name))
        return part.narrow(dim, 0, s.length)

    @staticmethod
    def backward(ctx, g):
        s, dim = ctx.s, ctx.dim
        size = -(-s.total // s.ranks)
        whole = _all_gather(_pad(g, dim, size), dim, _axis_group(s.mesh, s.dim_name))
        return whole.narrow(dim, 0, s.total), None, None, None


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

    def gather(self, x: torch.Tensor, seq_dim: int = 1, partial: bool = True) -> torch.Tensor:
        """The whole sequence of the stripes ``x`` that the ranks of the dim
        hold along ``seq_dim``, on ``x``'s device: an all-gather, whose
        backward reduce-scatters the gradient summed over those ranks (each
        rank's gradient of the whole sequence is one part of the sum), or
        without ``partial`` keeps this rank's stripe of its own gradient
        (every rank used the sequence alike). Ranks of the other mesh dims
        gather their own stripes apart; a host mesh's collectives run on
        the host."""
        if self.ranks == 1:
            return x
        return _StripeGather.apply(x, self, seq_dim, partial)

    def scatter(self, y: torch.Tensor, seq_dim: int = 1, summed: bool = True) -> torch.Tensor:
        """This stripe of the whole sequence ``y``: of the sum of the ranks'
        partial ``y`` where ``summed`` (a reduce-scatter), else of this
        rank's own; either way the backward all-gathers the gradient."""
        if self.ranks == 1:
            return y
        return _StripeScatter.apply(y, self, seq_dim, summed)

    def keep(self, x: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
        """This stripe of the whole sequence ``x`` (a view)."""
        return x.narrow(seq_dim, self.start, self.length)


# ------------------------------------------------------- the model axis
class _Copy(torch.autograd.Function):
    """A region's input, the same on every rank of the model axis; backward:
    the sum of the ranks' partial gradients (each rank's products used a
    part of the weights)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Sum(torch.autograd.Function):
    """The sum over the model axis of the ranks' partial ``y``; backward:
    the identity (every rank's use of the sum is the same), or with
    ``grad_sum`` the sum of the ranks' gradients too (each rank uses the sum
    in its own way)."""

    @staticmethod
    def forward(ctx, y, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        return _all_reduce(y, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.group) if ctx.grad_sum else g), None, None


class _Gather(torch.autograd.Function):
    """The ranks' equal chunks along ``dim`` concatenated; backward: this
    rank's chunk of the sum of the ranks' gradients (``grad_sum``: each
    rank used its own part of the whole) or of its own gradient (every
    rank used the whole alike)."""

    @staticmethod
    def forward(ctx, x, group, dim, grad_sum):
        ctx.group, ctx.dim, ctx.grad_sum, ctx.n = group, dim, grad_sum, x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        rank = ctx.group[0].get_coordinate()[ctx.group[1]]
        return g.narrow(ctx.dim, rank * ctx.n, ctx.n), None, None, None


def _halves_plan(n: int, r: int) -> tuple:
    """Where rank ``r``'s two blocks of a ``[D, 2 C]`` weight's contiguous
    column chunk go, and where its own blocks come from, over ``n`` ranks:
    global block ``k`` (``C / n`` columns) holds channels of rank ``k % n``
    (the first half of the columns for ``k < n``, the second for ``k >=
    n``). Returns ``(sends, sources)``: ``sends`` the local blocks (0, 1)
    in destination-rank order with their destinations, ``sources`` the
    ranks that send this rank its first-half and second-half blocks."""
    sends = sorted(((2 * r + b) % n, b) for b in (0, 1))
    return sends, (r // 2, (r + n) // 2)


class _Halves(torch.autograd.Function):
    """A ``[D, 2 C / n]`` chunk of a ``[D, 2 C]`` weight whose two halves are
    read as channels (Mamba's ``in_proj``, ``x ‖ z``) exchanged for this
    rank's channels of both halves, ``[D, 2 C / n]`` = ``[x_r ‖ z_r]``: one
    all-to-all over the model axis (backward the reverse)."""

    @staticmethod
    def forward(ctx, w, group):
        mesh, i = group
        n, r = mesh.size(i), mesh.get_coordinate()[i]
        c = w.shape[1] // 2
        sends, sources = _halves_plan(n, r)
        ins = [0] * n
        outs = [0] * n
        for dest, _ in sends:
            ins[dest] += c
        for src in sources:
            outs[src] += c
        rows = w.t()
        send = torch.cat([rows[b * c:(b + 1) * c] for _, b in sends])
        ctx.group, ctx.sends, ctx.ins, ctx.outs, ctx.c = group, sends, ins, outs, c
        got = _collective("all_to_all_single", send, group, outs, ins)
        return got.t()

    @staticmethod
    def backward(ctx, g):
        c = ctx.c
        back = _collective("all_to_all_single", g.t(), ctx.group, ctx.ins, ctx.outs)
        blocks = dict(zip((b for _, b in ctx.sends), back.split(c)))
        return torch.cat([blocks[0], blocks[1]]).t(), None


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on a model axis of ``size`` ranks (coordinate
    ``rank``), where ``activation_partitioning="seq"`` splits the positions
    over it its ``stripe`` of the sequence (else ``None``), and whether the
    region it is handed to is ``split`` over the axis. ``ModelAxis()`` is
    the axis of one device or of a mesh whose model axis has one rank:
    nothing is split and nothing moves.

    A tensor-parallel region (the products of one module: attention, the
    dense FFN, the Mamba mixer, the head) takes its input from the residual
    stream through :meth:`enter` and gives its output back through
    :meth:`exit`. A split region (the module's weights split over the
    axis: column-parallel products in, row-parallel products out) enters
    with the same whole input on every rank (under ``"seq"`` the stripes
    all-gathered) and exits with the sum of the ranks' partial outputs (an
    all-reduce; under ``"seq"`` a reduce-scatter to the stripes); the
    backward sums the ranks' partial input gradients. A region that is not
    split (the MoE; a module whose weights the specs leave whole) computes
    the same thing on every rank: it enters and exits as it is (under
    ``"seq"`` gathering the stripes and keeping its own, the gradient of
    every rank whole). The model decides which regions are split, once a
    layer, from the specs' placements (:meth:`region`)."""

    mesh: object = None
    name: str = "model"
    rank: int = 0
    size: int = 1
    stripe: Stripe | None = None
    split: bool = False

    @classmethod
    def of(cls, mesh, name: str, stripe: Stripe | None = None) -> "ModelAxis":
        i = mesh.mesh_dim_names.index(name)
        return cls(mesh, name, mesh.get_coordinate()[i], mesh.size(i), stripe)

    def region(self, split: bool) -> "ModelAxis":
        """This axis handed to a region that is ``split`` over it or not (a
        model axis of one rank splits nothing)."""
        return dataclasses.replace(self, split=split and self.size > 1)

    @property
    def group(self) -> tuple:
        return _axis_group(self.mesh, self.name)

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """A region's input ``[B, T, D]`` (whole over the sequence) from the
        residual stream's ``h``."""
        if self.stripe is not None:
            return self.stripe.gather(h, 1, partial=self.split)
        return _Copy.apply(h, self.group) if self.split else h

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """The residual stream's share of a region's output ``y``: the sum
        of the ranks' partial outputs where the region is split, under
        ``"seq"`` this rank's stripe of it."""
        if self.stripe is not None:
            return self.stripe.scatter(y, 1, summed=self.split)
        return _Sum.apply(y, self.group, False) if self.split else y

    def sum(self, y: torch.Tensor, grad_sum: bool = False) -> torch.Tensor:
        """The sum of the ranks' partial ``y``; backward the identity, or the
        sum of the ranks' gradients with ``grad_sum`` (the ranks use the
        sum in different ways: Mamba's ``x_proj`` output)."""
        return _Sum.apply(y, self.group, grad_sum)

    def gather(self, x: torch.Tensor, dim: int, grad_sum: bool = True) -> torch.Tensor:
        """The ranks' equal chunks ``x`` concatenated along ``dim``; backward
        a reduce-scatter of the summed gradient (``grad_sum``: each rank
        uses its own part of the whole) or this rank's chunk of its own."""
        return _Gather.apply(x, self.group, dim, grad_sum)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks (no gradient)."""
        return _all_reduce(x.detach(), self.group, "max")

    def channels(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous column chunk ``[D, 2 C / n]`` of a weight
        whose halves are read as ``C`` channels each, exchanged for its own
        channels of both halves (``[x_r ‖ z_r]``)."""
        return _Halves.apply(w, self.group)
