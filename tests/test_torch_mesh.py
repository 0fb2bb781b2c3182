"""The port's sharding specs, shapes and dry-run arithmetic against the
reference (ROADMAP Queue 1 item 8d), for repro-100m and the ten
configs, full and reduced, on the production axes (single- and multi-pod).

Specs are compared entry by entry after the port's flat ``layers`` layout
is mapped through the layer-stacking rule (``convert.stack_layers``: a
stacked leaf's spec gains a leading ``None``) and a one-axis tuple entry is
read as its axis (JAX's ``PartitionSpec`` does the same). Shapes, dtypes,
``pick_accum``, ``SHAPES``, ``cells_for``, ``supports_long_context`` and
``analytic_model_flops``: ``==``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
from repro.launch import specs as jspecs
from repro.launch.train import repro_100m as ref_repro_100m
from repro.models import Axes as JAxes
from repro.models import Model as JModel
from repro.train.optimizer import adamw_state_specs as ref_adamw_state_specs
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_to_reference, stack_layers, stacked_spec
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import P, mesh_axes
from repro_torch.launch.train import repro_100m
from repro_torch.models.layers import Axes
from repro_torch.models.model import Model
from repro_torch.train.optimizer import adamw_state_specs
from repro_torch.train.pytree import tree_leaves

ARCHS = list(jconfigs.ALIASES)
CASES = ["repro-100m"] + ARCHS + [f"reduced:{a}" for a in ARCHS]
AXES = [False, True]  # multi-pod


def _configs(name):
    if name == "repro-100m":
        return ref_repro_100m(), repro_100m()
    if name.startswith("reduced:"):
        a = name.split(":", 1)[1]
        return jconfigs.get_reduced_config(a), tconfigs.get_reduced_config(a)
    return jconfigs.get_config(name), tconfigs.get_config(name)


def _entry(e):
    if isinstance(e, tuple) and len(e) == 1:
        return e[0]
    return e


def _norm(tree):
    """Specs of either package as nested dicts/tuples of entry tuples."""
    if isinstance(tree, (P, JP)):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_norm(v) for v in tree)
    if hasattr(tree, "m"):  # AdamWState
        return {"step": _norm(tree.step), "m": _norm(tree.m), "v": _norm(tree.v)}
    raise TypeError(type(tree))


def _models(name, multi_pod):
    jcfg, tcfg = _configs(name)
    dp, tp = mesh_axes(multi_pod)
    return JModel(jcfg, JAxes(dp=dp, tp=tp), None), Model(tcfg, "cpu", ax=Axes(dp=dp, tp=tp))


@pytest.mark.parametrize("multi_pod", AXES)
@pytest.mark.parametrize("name", CASES)
def test_param_specs_equal_the_reference(name, multi_pod):
    jm, tm = _models(name, multi_pod)
    got = lm_params_to_reference(tm.cfg, tm.param_specs(), stack=stacked_spec)
    assert _norm(got) == _norm(jm.param_specs())
    opt = adamw_state_specs(tm.param_specs())
    got_opt = dataclasses.replace(opt, m=lm_params_to_reference(tm.cfg, opt.m, stacked_spec),
                                  v=lm_params_to_reference(tm.cfg, opt.v, stacked_spec))
    assert _norm(got_opt) == _norm(ref_adamw_state_specs(jm.param_specs()))


@pytest.mark.parametrize("multi_pod", AXES)
@pytest.mark.parametrize("name", CASES)
def test_cache_specs_equal_the_reference(name, multi_pod):
    jm, tm = _models(name, multi_pod)
    prefix, blocks = stack_layers(tm.cfg, tm.cache_specs(), stacked_spec)
    assert _norm({"prefix": prefix, "blocks": blocks}) == _norm(jm.cache_specs())


@pytest.mark.parametrize("name", CASES)
def test_init_shapes_equal_the_reference(name):
    """Shapes and dtypes, leaf by leaf; the port's are ``meta`` tensors."""
    jm, tm = _models(name, False)
    want = jm.init_shapes()
    got = lm_params_to_reference(tm.cfg, tm.init_shapes())
    g_leaves, w_leaves = tree_leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == jnp.dtype(w.dtype).name


class FakeMesh:
    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESHES = [FakeMesh(data=16, model=16), FakeMesh(pod=2, data=16, model=16)]


@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ["repro-100m"] + ARCHS)
def test_sanitize_spec_equals_the_reference(name, mesh):
    """Every parameter's spec at its shape on the production meshes."""
    multi = "pod" in mesh.shape
    jm, _ = _models(name, multi)
    shapes = jax.tree.leaves(jm.init_shapes())
    specs = jax.tree.leaves(jm.param_specs(), is_leaf=lambda x: isinstance(x, JP))
    assert len(shapes) == len(specs)
    for shape, spec in zip(shapes, specs):
        want = jspecs.sanitize_spec(shape.shape, spec, mesh)
        got = tspecs.sanitize_spec(shape.shape, P(*spec), mesh)
        assert _norm(got) == _norm(want), (shape.shape, spec)


def test_sanitize_spec_hubert_vocab_and_the_reference_cases():
    """The reference's own cases (tests/test_extensions.py): a 1-device mesh
    keeps every axis; hubert's 504-word vocab on a 16-way axis is
    replicated; with a real mesh on a fake 16x16 process group too."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    one = FakeMesh(data=1, model=1)
    assert tspecs.sanitize_spec((504, 10), P("data", "model"), one) == P("data", "model")
    got = tspecs.sanitize_spec((504, 1280), P("model", "data"), MESHES[0])
    assert got[0] is None and got[1] == "data"
    assert _norm(got) == _norm(jspecs.sanitize_spec((504, 1280), JP("model", "data"), MESHES[0]))
    assert tspecs.sanitize_spec((504, 10, 3), P(("data", "model")), MESHES[0]) == \
        P(None, None, None)
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh()
        assert tspecs.sanitize_spec((504, 1280), P("model", "data"), mesh) == P(None, "data")
        assert tspecs.local_shape((512, 1280), P("model", "data"), mesh) == (32, 80)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("n_tp", [1, 16])
@pytest.mark.parametrize("n_dp", [1, 16, 32])
@pytest.mark.parametrize("name", ["repro-100m"] + ARCHS)
def test_pick_accum_equals_the_reference(name, n_dp, n_tp):
    jcfg, tcfg = _configs(name)
    for shape in jconfigs.SHAPES:
        want = jspecs.pick_accum(jcfg, jconfigs.SHAPES[shape], n_dp, n_tp=n_tp)
        assert tspecs.pick_accum(tcfg, tconfigs.SHAPES[shape], n_dp, n_tp=n_tp) == want


@pytest.mark.parametrize("name", CASES)
def test_shapes_cells_and_long_context_equal_the_reference(name):
    jcfg, tcfg = _configs(name)
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tcfg.supports_long_context == jcfg.supports_long_context
    arch = name.split(":")[-1]
    assert tconfigs.cells_for(arch, tcfg) == jconfigs.cells_for(arch, jcfg)
    if name in ARCHS:
        assert tconfigs.cells_for(name) == jconfigs.cells_for(name)


@pytest.mark.parametrize("name", CASES)
def test_analytic_model_flops_equal_the_reference(name):
    jcfg, tcfg = _configs(name)
    for shape, spec in jconfigs.SHAPES.items():
        for kind in ("train", "prefill", "decode"):
            assert tspecs.analytic_model_flops(tcfg, tconfigs.SHAPES[shape], kind) == \
                jspecs.analytic_model_flops(jcfg, spec, kind)


def test_sds_allocates_nothing():
    """Outside a fake mode ``sds`` places a ``meta`` shard; under one a fake
    shard; its global shape is the whole tensor's."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        mesh = make_production_mesh(multi_pod=True)
        t = tspecs.sds((4096, 151936), torch.bfloat16, P(("pod", "data"), "model"), mesh)
        assert tuple(t.shape) == (4096, 151936) and t.to_local().device.type == "meta"
        assert tuple(t.to_local().shape) == (128, 9496)
        with FakeTensorMode():
            f = tspecs.sds((256, 4096), torch.int32, P(("pod", "data"), None), mesh)
        assert isinstance(f.to_local(), FakeTensor) and tuple(f.to_local().shape) == (8, 4096)
    finally:
        dist.destroy_process_group()


class _CoordMesh:
    """``local_slice``'s view of one rank of a mesh: its sizes and its
    coordinate."""

    def __init__(self, sizes, coord):
        self.sizes, self.coord = sizes, coord

    def size(self, i):
        return self.sizes[i]

    def get_coordinate(self):
        return list(self.coord)


@pytest.mark.parametrize("spec", [P("data", "model"), P("model", "data"), P(None, ("pod", "data")),
                                  P(("pod", "data"), "model", None), P(("pod", "data", "model")),
                                  P(None, None)])
def test_grouped_gather_reassembles_every_placement(spec):
    """``gather_tree``'s reassembly (``_unshard``): each rank's shard
    (``local_slice``) as a row, in the order DTensor chunks ``Shard(0)``
    over the mesh dims that shard the tensor (the first major), gives the
    whole tensor back, for a dim split over one axis or over two (pod
    major, as JAX orders ``("pod", "data")``)."""
    import itertools

    from torch.distributed.tensor import Shard

    from repro_torch.launch.mesh import _unshard, local_slice, placements

    class Names:
        mesh_dim_names = ("pod", "data", "model")

    sizes = (2, 2, 2)
    shape = (8, 4, 6)[:len(spec)]
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    places = placements(spec, Names())
    sharded = [i for i, pl in enumerate(places) if isinstance(pl, Shard)]
    rows = []
    for coord in itertools.product(*(range(sizes[i]) for i in sharded)):
        full_coord = [0, 0, 0]
        for i, c in zip(sharded, coord):
            full_coord[i] = c
        rows.append(local_slice(full, places, _CoordMesh(sizes, full_coord)).reshape(-1))
    local_shape = local_slice(full, places, _CoordMesh(sizes, [0, 0, 0])).shape
    got = _unshard(torch.stack(rows), places, [sizes[i] for i in sharded], local_shape, shape)
    assert torch.equal(got, full)
