"""The port's mesh path on the CPU: gloo ranks, float32, against the one-device
run (ROADMAP Queue 1 item 8d).

Two spawns of ranks (2 and 4) run everything that needs a group; the
one-device baselines run in this process. Reduced qwen3-8b and reduced
jamba-v0.1-52b take 3 steps of ``python -m repro_torch.launch.train`` (its
``main``, as a rank of the test's group) at B=4, T=16 on meshes 2x1, 1x2
and 2x2. Tolerances:

* losses and grad norms: rtol 1e-5; every parameter and both AdamW
  moments of the final checkpoint: 1e-5 relative L2 per tensor. A data
  axis splits the batch, so the gradient is summed in another order (the
  observed gap is 3e-8); a model axis splits the products (tensor
  parallelism), so the ranks' partial sums add in another order than one
  device's products (observed up to 8e-6). A parameter's entries that
  float32 does not resolve (``tests/mesh_tolerance.py``: where the
  one-device float32 run misses a float64 run of the same program from the
  same parameters) are held within twice the summed learning rates
  instead: reduced jamba's first Mamba ``conv_b``, zero at init, reads
  3.0e-5 off on 1x2, and both float32 runs stand 1.6e-5 and 1.8e-5 off the
  float64 run, so the gap is float32's, not the split's.
* jamba's MoE routes each data shard's tokens on its own, as the
  reference's ``moe_ffn`` does inside its ``shard_map`` (its capacity is
  the shard's, its aux loss the mean of the shards'): on a data axis of 2
  the one-device baseline is the same model with each half of the batch
  routed on its own. On 1x2 it is the plain one-device run.
* serve tokens and ``moe_ffn_fshard``: ``==`` tokens, 1e-6 relative on
  the MoE's float32 output.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.models.model as model_mod
from repro_torch.configs import get_reduced_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models.layers import moe_ffn
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.pytree import tree_leaves
from mesh_tolerance import assert_param_close, float64_program

ARCHS = ("reduced:qwen3-8b", "reduced:jamba-v0.1-52b")
TRAIN = ["--steps", "3", "--global-batch", "4", "--seq-len", "16", "--log-every", "100",
         "--device", "cpu", "--dtype", "float32"]
SERVE = ["--batch", "4", "--prompt-len", "3", "--gen", "3", "--device", "cpu"]
SERVE_CASES = (("reduced:qwen3-8b", None), ("reduced:jamba-v0.1-52b", "moe_weight_shard=f"))
RTOL = 1e-5


def _name(arch: str, mesh: str) -> str:
    return f"{arch.split(':')[1]}_{mesh}"


def _serve_args(arch, opt, mesh):
    return ["--arch", arch, *SERVE, "--mesh", mesh, *(["--opt", opt] if opt else [])]


def _fshard_case(mesh_shape):
    """``moe_ffn_fshard`` on this rank's rows with ``specs_moe_fshard``'s
    shards, and the rows gathered whole; jamba's float32 MoE, B=4."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import P, local_slice, make_debug_mesh, placements, shard_tree
    from repro_torch.models.layers import Axes, Init, init_moe, moe_ffn_fshard, specs_moe_fshard

    cfg = dataclasses.replace(get_reduced_config("jamba-v0.1-52b"), dtype="float32")
    mesh = make_debug_mesh(*mesh_shape)
    p = init_moe(Init(torch.Generator().manual_seed(3), "cpu"), cfg.d_model, cfg.d_ff_expert
                 or cfg.d_ff, cfg.n_experts, cfg.n_shared_experts, cfg.activation, torch.float32)
    x = torch.randn((4, 3, cfg.d_model), generator=torch.Generator().manual_seed(4))
    ps = shard_tree(p, specs_moe_fshard(Axes(), cfg.activation, cfg.n_shared_experts), mesh)
    ps["router"] = p["router"]
    if "shared" in p:
        ps["shared"] = p["shared"]
    rows = placements(P(("data",), None, None), mesh)
    with torch.no_grad():
        y, aux = moe_ffn_fshard(local_slice(x, rows, mesh), ps, cfg, Axes(), mesh,
                                batch_axes=("data",))
    y = DTensor.from_local(y, mesh, rows, run_check=False).full_tensor()
    return y, aux


def _accum_run(mesh_shape=None):
    """Two steps of reduced qwen3-8b (float32) with ``accum=2`` through the
    library: on a mesh the batch leaves are DTensors ``[2, 2, 16]`` split
    over ``data`` on their rows. Returns the losses and the final
    parameters, whole."""
    from repro_torch.launch.mesh import P, gather_tree, make_debug_mesh, shard, shard_tree
    from repro_torch.models.layers import Axes
    from repro_torch.models.model import Model
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_reduced_config("qwen3-8b"), dtype="float32")
    mesh = make_debug_mesh(*mesh_shape) if mesh_shape else None
    model = Model(cfg, "cpu", ax=Axes(), mesh=mesh)
    params = model.init(torch.Generator().manual_seed(0))
    if mesh is not None:
        params = shard_tree(params, model.param_specs(), mesh)
    opt = adamw_init(params)
    step = make_train_step(model, warmup=1, total_steps=4, accum=2)
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=5)
    losses = []
    for _ in range(2):
        batch = {k: torch.from_numpy(v).long().reshape(2, 2, 16) for k, v in next(pipe).items()}
        if mesh is not None:
            batch = {k: shard(v, P(None, ("data",), None), mesh) for k, v in batch.items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    pipe.close()
    full = gather_tree(params) if mesh is not None else params
    return losses, [t.detach().tolist() for t in tree_leaves(full)]


def _gather_gradients(rank):
    """The gradient of a [8, 6] weight sharded (Shard(0), Shard(1)) on a
    2x2 mesh, gathered with three ``grad_placements``, the batch split over
    ``data``: each gradient gathered whole."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.launch.mesh import P, batch_grad_placements, local_slice, make_debug_mesh
    from repro_torch.launch.mesh import placements, shard

    mesh = make_debug_mesh(2, 2)
    g = torch.Generator().manual_seed(7)
    w_full, x_full = torch.randn((8, 6), generator=g), torch.randn((4, 8), generator=g)
    x = local_slice(x_full, placements(P(("data",), None), mesh), mesh)
    out = {}
    for name, gp in (("plain", None), ("partial_partial", (Partial(), Partial())),
                     ("partial_replicate", (Partial(), Replicate())),
                     ("batch_grad_placements", batch_grad_placements(mesh, ("data",)))):
        w = shard(w_full, P("data", "model"), mesh).requires_grad_(True)
        w.grad = None
        y = x @ (w.full_tensor() if gp is None else w.full_tensor(grad_placements=gp))
        (y * y).sum().backward()
        out[name] = w.grad.full_tensor().tolist()
    return out


def _rank(rank, world, store, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    try:
        res = {}
        meshes = ("2x1", "1x2") if world == 2 else ("2x2",)
        for arch in ARCHS:
            for mesh in meshes:
                hist = []
                train_mod.main(["--arch", arch, *TRAIN, "--mesh", mesh, "--ckpt-dir",
                                os.path.join(out_dir, _name(arch, mesh))], hist)
                res[f"train_{_name(arch, mesh)}"] = hist
        if world == 2:
            for arch, opt in SERVE_CASES:
                for mesh in meshes:
                    gen, _ = serve_mod.run(serve_mod._parser().parse_args(
                        _serve_args(arch, opt, mesh)))
                    res[f"serve_{_name(arch, mesh)}"] = gen.tolist()
            res["accum_2x1"] = _accum_run((2, 1))
            for shape in ((2, 1), (1, 2)):
                y, aux = _fshard_case(shape)
                res[f"fshard_{shape[0]}x{shape[1]}"] = {"y": y.tolist(), "aux": float(aux)}
        else:
            res["gather_grads"] = _gather_gradients(rank)
        if rank == 0:
            with open(os.path.join(out_dir, f"world{world}.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _grouped(groups: int):
    """``moe_ffn`` routing each of ``groups`` row blocks on its own and
    averaging their aux losses: the reference's MoE on a data axis of
    ``groups`` ranks."""

    def moe(x, p, cfg, name_output=False):
        ys, auxs = zip(*(moe_ffn(xs, p, cfg, name_output) for xs in x.chunk(groups, 0)))
        return torch.cat(ys), sum(auxs) / groups

    return moe


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's work in this process on one thread, as each rank runs:
    the reduced models' many small ops stall on an intra-op pool when the
    host is loaded (other test workers, the ranks)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """The one-device baselines (here) and the ranks' runs (two spawns)."""
    out = tmp_path_factory.mktemp("sharded")
    for world in (2, 4):
        torch.multiprocessing.start_processes(
            _rank, args=(world, (out / f"store{world}").as_uri(), str(out)), nprocs=world,
            join=True, start_method="spawn")
    res = {}
    for world in (2, 4):
        res.update(json.loads((out / f"world{world}.json").read_text()))
    base = {}
    for arch in ARCHS:
        for name, groups in (("1x1", 1), ("1x1_routed2", 2)):
            if groups > 1 and "jamba" not in arch:
                continue
            hist = []
            saved = model_mod.moe_ffn
            model_mod.moe_ffn = _grouped(groups) if groups > 1 else saved
            try:
                train_mod.main(["--arch", arch, *TRAIN, "--ckpt-dir",
                                str(out / _name(arch, name))], hist)
                with float64_program():  # the same program and start in float64
                    train_mod.main(["--arch", arch, *TRAIN, "--dtype", "float64", "--ckpt-dir",
                                    str(out / _name(arch, name + "_f64"))], [],
                                   overrides={"opt_state_dtype": "float64"})
            finally:
                model_mod.moe_ffn = saved
            base[_name(arch, name)] = hist
    for arch, opt in SERVE_CASES:
        gen, _ = serve_mod.run(serve_mod._parser().parse_args(_serve_args(arch, opt, "1x1")))
        base[f"serve_{_name(arch, '1x1')}"] = gen.tolist()
    return res, base, out


def _baseline(arch: str, mesh: str) -> str:
    data = int(mesh.split("x")[0])
    return _name(arch, "1x1_routed2" if "jamba" in arch and data > 1 else "1x1")


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_equal_one_device(runs, arch, mesh):
    res, base, out = runs
    got, want = res[f"train_{_name(arch, mesh)}"], base[_baseline(arch, mesh)]
    assert [h["step"] for h in got] == [1, 2, 3]
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in got], [h[key] for h in want], rtol=RTOL,
                                   atol=1e-9, err_msg=key)
    like = train_mod.checkpoint_tree(train_mod.get_model_config(arch), *_meta_state(arch))
    got_tree, got_step = ckpt.restore_checkpoint(str(out / _name(arch, mesh)), like)
    want_tree, want_step = ckpt.restore_checkpoint(str(out / _baseline(arch, mesh)), like)
    assert got_step == want_step == 3
    want64 = tree_leaves(ckpt.restore_checkpoint(str(out / (_baseline(arch, mesh) + "_f64")),
                                                 like)[0][0])
    lr_sum = sum(h["lr"] for h in want)
    for i, (a, b) in enumerate(zip(tree_leaves(got_tree), tree_leaves(want_tree))):
        if i < len(want64):  # params, then step, m, v
            assert_param_close(a, b, want64[i], lr_sum, RTOL, (arch, mesh, i))
            continue
        a, b = a.double(), b.double()
        assert a.shape == b.shape
        assert float((a - b).norm()) <= RTOL * max(float(b.norm()), 1e-12)


def _meta_state(arch):
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init

    cfg = dataclasses.replace(train_mod.get_model_config(arch), dtype="float32")
    params = Model(cfg, "cpu").init_shapes()
    return params, adamw_init(params)


def test_accumulation_on_a_data_axis_equals_one_device(runs):
    """``accum=2`` with the microbatches' rows split over two data ranks:
    the losses and parameters of the one-device run with the same
    microbatches."""
    res, _, _ = runs
    got_losses, got_params = res["accum_2x1"]
    want_losses, want_params = _accum_run()
    np.testing.assert_allclose(got_losses, want_losses, rtol=RTOL)
    for a, b in zip(got_params, want_params):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= RTOL * max(np.linalg.norm(b), 1e-12)


def test_one_device_routing_differs_on_a_data_axis(runs):
    """The check above is not vacuous for jamba: its plain one-device run
    and the run routed per half batch part at step 1 (drops and the aux
    loss differ), and the 2x1 mesh follows the latter."""
    _, base, _ = runs
    plain, routed = base["jamba-v0.1-52b_1x1"], base["jamba-v0.1-52b_1x1_routed2"]
    assert plain[0]["loss"] != routed[0]["loss"]


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_serve_on_a_mesh_gives_the_one_device_tokens(runs, case, mesh):
    res, base, _ = runs
    assert res[f"serve_{_name(case, mesh)}"] == base[f"serve_{_name(case, '1x1')}"]


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_moe_ffn_fshard_on_two_ranks_equals_moe_ffn(runs, mesh):
    """The weight-stationary MoE with its F-slices on two data ranks (2x1:
    partial products summed) or its experts on two model ranks (1x2:
    gathered) gives ``moe_ffn``'s output on the whole batch."""
    from repro_torch.models.layers import Init, init_moe

    res, _, _ = runs
    cfg = dataclasses.replace(get_reduced_config("jamba-v0.1-52b"), dtype="float32")
    p = init_moe(Init(torch.Generator().manual_seed(3), "cpu"), cfg.d_model, cfg.d_ff_expert
                 or cfg.d_ff, cfg.n_experts, cfg.n_shared_experts, cfg.activation, torch.float32)
    x = torch.randn((4, 3, cfg.d_model), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want, aux = moe_ffn(x, p, cfg)
    got = np.asarray(res[f"fshard_{mesh}"]["y"], np.float32)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)
    assert res[f"fshard_{mesh}"]["aux"] == pytest.approx(float(aux), rel=1e-6)


def test_plain_gather_gradient_is_wrong_and_batch_placements_are_right(runs):
    """A gathered weight's gradient with the batch split over
    ``data`` is the whole gradient only with ``Partial`` on ``data`` and
    ``Replicate`` on ``model`` (``batch_grad_placements``); a plain
    ``full_tensor()`` gives something else, ``Partial`` on both twice it."""
    res, _, _ = runs
    g = torch.Generator().manual_seed(7)
    w_full, x_full = torch.randn((8, 6), generator=g), torch.randn((4, 8), generator=g)
    w = w_full.clone().requires_grad_(True)
    ((x_full @ w) ** 2).sum().backward()
    want = w.grad.numpy()
    got = {k: np.asarray(v, np.float32) for k, v in res["gather_grads"].items()}
    np.testing.assert_allclose(got["partial_replicate"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["batch_grad_placements"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["partial_partial"], 2 * want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got["plain"], want, rtol=1e-2, atol=1e-3)

