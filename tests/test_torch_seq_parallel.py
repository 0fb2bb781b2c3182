"""Sequence-parallel activations on the CPU: ``activation_partitioning="seq"``
on a model axis above 1, gloo ranks, float32 reduced configs.

Under ``"seq"`` a rank's residual stream is its stripe of the positions
(``launch.mesh.Stripe``); each tensor-parallel region (attention, the
Mamba mixer, the dense FFN, the head) gathers the stripes as it enters and
reduce-scatters its partial output back to them as it exits, a region
that is not split (the MoE) keeps its own stripe, and the norms' scales,
read on stripes, get their gradients summed over the model axis. Its
values are those of ``"batch"`` on the same mesh, which are the one-device
run's.

One spawn of 4 gloo ranks (2x2, and 1x4 at T=15 and T=5: stripes of 4, 4,
4, 3 and of 2, 2, 1, 0, an empty one), with the one-device baselines run
in this process meanwhile, then one of 2 (every case on 1x2, and 2x1 for
``moe_ffn_fshard``): one spawn at a time and few runs, since gloo ranks
that share the host's cores with other work wait on each other at every
collective (``WORLD_RUNS`` says which case runs where). Each run is 3 steps of ``make_train_step`` at B=2 (T=24
unless said: gemma3's 16-key window binds) from the same parameters, then
``make_prefill_step`` on the trained parameters. Tolerances:

* losses, ce, aux and grad norms rtol 1e-5; every parameter and both AdamW
  moments after step 3 within 1e-5 relative L2 per tensor, but for the
  parameter entries in Adam's eps regime (the baseline's ``sqrt(v)``
  non-zero and under 1e-7, ten times AdamW's eps): there ``m / (sqrt(v) +
  eps)`` turns a float32 sum-order difference of a 1e-9 gradient into a
  different step (observed: reduced jamba's embedding, 10 of 65,536 entries
  at ``sqrt(v)`` 5e-9, 1.1e-5 of the tensor's norm; every gradient agrees
  within 1e-5). Those entries are held within twice the summed learning
  rates (a bound every AdamW step obeys), the rest at 1e-5; both moments,
  which carry the gradients themselves, are held at 1e-5 everywhere. Each
  rank's prefill logits of the last position ``==`` every other rank's and
  within 1e-5 of the one-device run's. The split changes only the order
  of sums (observed gaps about 1e-7). Since the model axis splits the
  products (tensor parallelism), the ranks' partial sums add in another
  order than one device's products; a parameter's entries that float32
  does not resolve (``tests/mesh_tolerance.py``: where the one-device
  float32 run misses a float64 run of the same program from the same
  parameters, which every baseline gets) are held within twice the summed
  learning rates too (reduced jamba's zero-init Mamba ``conv_b`` read
  1.1e-5 off as a whole).
* jamba's ``moe_weight_shard="d"`` MoE routes each data shard's tokens on
  its own (the reference's per-shard ``moe_ffn``), so on a data axis of 2
  its one-device baseline routes each half batch on its own.
  ``moe_weight_shard="f"`` (``moe_ffn_fshard``) gathers the rows and routes
  the whole batch, so its baseline is the plain one-device ``"d"`` run.
* qwen3-8b starts from the reference's parameters (``convert.
  lm_params_from_arrays``), and its one-device first step is held against
  ``repro``'s within 1e-4 (``tests/test_torch_train.py``'s tolerance).
* ``Stripe.gather``: its gradient ``==`` the stripe of the sum of the
  ranks' gradients (a reduce-scatter), at T=6 on 1x2 and 2x2 and T=5 on
  1x4.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro_torch.models.model as model_mod
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import stripe
from repro_torch.models.layers import moe_ffn
from mesh_tolerance import assert_param_close, float64_program

RTOL = 1e-5
REF_TOL = 1e-4
EPS_REGIME = 1e-7  # sqrt(v) below 10x AdamW's eps of 1e-8
B, T, STEPS = 2, 24, 3
# name -> (reduced arch, config overrides)
CASES = {
    "qwen3": ("qwen3-8b", {}),
    "gemma3": ("gemma3-12b", {}),
    # one block of jamba's eight layers (attention, Mamba, MoE), not two
    "jamba_d": ("jamba-v0.1-52b", {"n_blocks": 1}),
    "jamba_f": ("jamba-v0.1-52b", {"n_blocks": 1, "moe_weight_shard": "f"}),
    "deepseek_v2": ("deepseek-v2-236b", {}),
    "llama_vision": ("llama-3.2-vision-90b", {}),
    "hubert": ("hubert-xlarge", {}),
}
MODES = ("seq", "batch")
ALL = tuple(CASES)
# (mesh, T, modes, cases) of each world's runs. Every case in "seq" on 1x2;
# on 4 ranks the cases that a data axis or a short stripe changes: qwen3
# and jamba "f" (the scan, moe_ffn_fshard's gathers) on 2x2 in both modes,
# jamba "d" (its routing follows the data shards) in "seq"; T=15's stripes
# of 4, 4, 4, 3 for qwen3, T=5's (2, 2, 1 and an empty one) for qwen3, MLA
# and hubert's frames. "batch" on a model axis alone splits nothing but the
# weights, gathered whole (tests/test_torch_sharded_train.py holds it on
# 1x2). The runs are few because gloo ranks that share the host's cores
# with the other test workers wait on each other at every collective.
WORLD_RUNS = {4: (((2, 2), T, MODES, ("qwen3", "jamba_f")), ((2, 2), T, ("seq",), ("jamba_d",)),
                  ((1, 4), 15, ("seq",), ("qwen3",)),
                  ((1, 4), 5, ("seq",), ("qwen3", "deepseek_v2", "hubert"))),
              2: (((1, 2), T, ("seq",), ALL),)}
# the cases whose "d" MoE routes each data shard on its own
PER_SHARD_MOE = ("jamba_d", "deepseek_v2")
FSHARD_2X1 = ((2, 1), T)  # jamba_f's train step through moe_ffn_fshard on a data axis of 2
GATHER_CASES = {2: (((1, 2), 6),), 4: (((2, 2), 6), ((1, 4), 5))}


def _cfg(case: str, mode: str):
    arch, over = CASES[case]
    return dataclasses.replace(get_reduced_config(arch), dtype="float32",
                               activation_partitioning=mode, **over)


def _batch(cfg, step: int, t: int) -> dict:
    rng = np.random.default_rng(1000 * step + 7)
    out = {}
    if cfg.frontend == "frames":
        out["frames"] = torch.from_numpy(rng.standard_normal((B, t, cfg.d_model))
                                         .astype(np.float32))
    else:
        out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, t), dtype=np.int64))
    out["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, t), dtype=np.int64))
    if cfg.n_img_tokens:
        out["image_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    return out


def _init(case: str, cfg, init_dir: str) -> dict:
    """The run's first parameters: the reference's for qwen3 (written by the
    fixture), ``Model.init`` at seed 0 for the rest."""
    from repro_torch.models.model import Model

    path = os.path.join(init_dir, f"init_{case}.pt")
    if os.path.exists(path):
        return torch.load(path)
    return Model(cfg, "cpu").init(torch.Generator().manual_seed(0))


def _run(case: str, mesh_shape, mode: str, t: int, init_dir: str,
         dtype: str = "float32") -> dict:
    """3 train steps and a prefill of ``case`` on ``mesh_shape`` (``None``:
    one device, no group), in ``dtype`` (``"float64"``: the same program
    and first parameters in float64, under ``mesh_tolerance.
    float64_program``). Returns the metrics of each step, the final
    parameters and both moments whole (as tree leaves), and this rank's
    prefill logits of the last position."""
    from repro_torch.launch.mesh import P, gather_tree, make_debug_mesh, shard, shard_tree
    from repro_torch.models.layers import Axes
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.pytree import tree_leaves, tree_map
    from repro_torch.train.step import make_prefill_step, make_train_step

    cfg = dataclasses.replace(_cfg(case, mode), dtype=dtype)
    mesh = make_debug_mesh(*mesh_shape) if mesh_shape else None
    model = Model(cfg, "cpu", ax=Axes(), mesh=mesh)
    params = tree_map(lambda x: x.to(model.dtype), _init(case, cfg, init_dir))
    if mesh is not None:
        params = shard_tree(params, model.param_specs(), mesh)
    opt = adamw_init(params, dtype)
    step = make_train_step(model, warmup=1, total_steps=4)

    def placed(batch):
        if mesh is None:
            return batch
        return {k: shard(v, P(("data",), *([None] * (v.dim() - 1))), mesh)
                for k, v in batch.items()}

    hist = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, placed(_batch(cfg, i, t)))
        hist.append({k: float(v) for k, v in m.items()})
    with torch.no_grad():
        last = make_prefill_step(model)(params, placed(_batch(cfg, STEPS, t)))
    if mesh is not None:
        params, m, v = gather_tree(params), gather_tree(opt.m), gather_tree(opt.v)
    else:
        m, v = opt.m, opt.v
    return {"hist": hist, **{name: [x.detach().clone() for x in tree_leaves(tree)]
                             for name, tree in (("params", params), ("m", m), ("v", v))},
            "prefill": last.detach().clone()}


def _gather_case(mesh_shape, t: int) -> dict:
    """``Stripe.gather`` of a [2, t, 3] sequence's stripes on this rank, and the
    gradient its stripe gets from ``sum(whole * w)`` with ``w`` differing
    by rank."""
    from repro_torch.launch.mesh import Stripe, make_debug_mesh

    mesh = make_debug_mesh(*mesh_shape)
    s = Stripe.of(mesh, "model", t)
    full = torch.randn((2, t, 3), generator=torch.Generator().manual_seed(11))
    x = s.keep(full).clone().requires_grad_(True)
    whole = s.gather(x)
    rank = int(torch.distributed.get_rank())
    (whole * _gather_weight(t, rank)).sum().backward()
    return {"whole_equal": bool(torch.equal(whole, full)), "grad": x.grad.clone(),
            "start": s.start, "length": s.length}


def _gather_weight(t: int, rank: int) -> torch.Tensor:
    return torch.arange(2 * t * 3, dtype=torch.float32).reshape(2, t, 3) * (rank + 1)


def _rank(rank, world, store, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    try:
        res = {}
        for mesh_shape, t, modes, cases in WORLD_RUNS[world]:
            for case in cases:
                for mode in modes:
                    res[(case, mesh_shape, t, mode)] = _run(case, mesh_shape, mode, t, out_dir)
        if world == 2:
            mesh_shape, t = FSHARD_2X1
            res[("jamba_f", mesh_shape, t, "batch")] = _run("jamba_f", mesh_shape, "batch", t,
                                                            out_dir)
        for mesh_shape, t in GATHER_CASES[world]:
            res[("gather", mesh_shape, t)] = _gather_case(mesh_shape, t)
        torch.save(res, os.path.join(out_dir, f"world{world}_rank{rank}.pt"))
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


def _reference_qwen3(init_dir: str) -> dict:
    """The reference's reduced qwen3-8b parameters (carried to the port for
    every qwen3 run) and its first train step's metrics, parameters and
    moments on the first batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.configs as jconfigs
    from repro.compat import use_mesh
    from repro.models import Axes as JAxes
    from repro.models import Model as JaxModel
    from repro.train.optimizer import adamw_init as ref_adamw_init
    from repro.train.step import make_train_step as ref_make_train_step

    from repro_torch.convert import lm_params_from_arrays

    cfg = _cfg("qwen3", "batch")
    jcfg = dataclasses.replace(jconfigs.get_reduced_config("qwen3-8b"), dtype="float32")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jmodel = JaxModel(jcfg, JAxes(dp=("data",), tp="model"), mesh)
    with use_mesh(mesh):
        jparams = jmodel.init(jax.random.key(0))
        step = jax.jit(ref_make_train_step(jmodel, warmup=1, total_steps=4))
        batch = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in _batch(cfg, 0, T).items()}
        p, o, m = step(jparams, ref_adamw_init(jparams), batch)
    torch.save(lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams), "cpu"),
               os.path.join(init_dir, "init_qwen3.pt"))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "leaves": [np.asarray(x) for x in jax.tree.leaves((p, o.m, o.v))]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs (two spawns), the one-device baselines (here, beside
    the first) and the reference's qwen3 step."""
    out = tmp_path_factory.mktemp("seq_parallel")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _reference_qwen3(str(out))

        def spawn(world: int, join: bool):
            return torch.multiprocessing.start_processes(
                _rank, args=(world, (out / f"store{world}").as_uri(), str(out)), nprocs=world,
                join=join, start_method="spawn")

        ctx = spawn(4, join=False)
        base = {}
        saved = model_mod.moe_ffn
        for mesh_shape, t, _, cases in (r for runs_ in WORLD_RUNS.values() for r in runs_):
            for case in cases:
                key = _baseline_key(case, mesh_shape, t)
                if key in base:
                    continue
                model_mod.moe_ffn = _grouped(2) if key[2] else saved
                try:
                    base[key] = _run(key[0], None, "batch", t, str(out))
                    with float64_program():
                        base[key]["params64"] = _run(key[0], None, "batch", t, str(out),
                                                     "float64")["params"]
                finally:
                    model_mod.moe_ffn = saved
        while not ctx.join():
            pass
        spawn(2, join=True)
    finally:
        torch.set_num_threads(threads)
    ranks = {world: [torch.load(out / f"world{world}_rank{r}.pt") for r in range(world)]
             for world in WORLD_RUNS}
    return ranks, base, ref, out


def _baseline_key(case: str, mesh_shape, t: int) -> tuple:
    """``(case, T, routed per half batch)`` of the one-device run that
    ``case`` on ``mesh_shape`` is held against."""
    if case == "jamba_f":  # the weight-stationary MoE routes the whole batch
        return "jamba_d", t, False
    return case, t, case in PER_SHARD_MOE and mesh_shape[0] > 1


def _baseline(base: dict, case: str, mesh_shape, t: int) -> dict:
    return base[_baseline_key(case, mesh_shape, t)]


def _assert_run(got: dict, want: dict, what: str, rows=slice(None), params64=None) -> None:
    """``got`` (rank 0's, or with ``rows`` another rank's run: its batch
    rows of the prefill logits) against ``want``; ``params64`` the float64
    one-device run's parameters (``want``'s where it has them)."""
    params64 = want["params64"] if params64 is None else params64
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in got["hist"]], [h[key] for h in want["hist"]],
                                   rtol=RTOL, atol=1e-9, err_msg=f"{what}: {key}")
    lr_sum = sum(h["lr"] for h in want["hist"])
    for name in ("params", "m", "v"):
        assert len(got[name]) == len(want[name])
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            a, b = a.double(), b.double()
            assert a.shape == b.shape, (what, name, i)
            if name == "params":  # Adam's eps regime and float32's unresolved entries apart
                rms = want["v"][i].double().sqrt()
                eps_regime = (rms > 0) & (rms < EPS_REGIME)
                assert bool(((a - b)[eps_regime].abs() <= 2 * lr_sum).all()), (what, i)
                assert_param_close(a, b, params64[i], lr_sum, RTOL, (what, i), ~eps_regime)
                continue
            err = float((a - b).norm())
            assert err <= RTOL * max(float(b.norm()), 1e-12), (what, name, i, err)
    np.testing.assert_allclose(got["prefill"].numpy(), want["prefill"][rows].numpy(), rtol=RTOL,
                               atol=RTOL, err_msg=f"{what}: prefill")


def _rows(mesh_shape, rank: int) -> slice:
    """The batch rows of rank ``rank`` of a (data, model) mesh."""
    n = B // mesh_shape[0]
    coord = rank // mesh_shape[1]
    return slice(coord * n, (coord + 1) * n)


MESH_RUNS = [(case, world, mesh_shape, t, mode) for world, runs_ in WORLD_RUNS.items()
             for mesh_shape, t, modes, cases in runs_ for case in cases for mode in modes]
BOTH_MODES = sorted({(case, world, mesh_shape, t) for case, world, mesh_shape, t, mode in MESH_RUNS
                     if mode == "batch"})


def _run_id(case, world, mesh_shape, t, mode=None):
    return f"{case}-{mesh_shape[0]}x{mesh_shape[1]}_T{t}" + (f"_{mode}" if mode else "")


@pytest.mark.parametrize("case,world,mesh_shape,t,mode", MESH_RUNS,
                         ids=[_run_id(*r) for r in MESH_RUNS])
def test_mesh_run_equals_one_device(runs, case, world, mesh_shape, t, mode):
    """Losses, grad norms, the final parameters and moments, and every
    rank's prefill logits of ``case`` on the mesh equal the one-device
    run's (``"seq"`` splitting the sequence over the model axis, uneven
    and empty stripes included; ``"batch"`` not splitting it)."""
    ranks, base, _, _ = runs
    want = _baseline(base, case, mesh_shape, t)
    got = ranks[world][0][(case, mesh_shape, t, mode)]
    _assert_run(got, want, f"{case} {mesh_shape} T={t} {mode}", _rows(mesh_shape, 0))
    for r in range(1, world):  # the same gathered state on every rank; its own prefill rows
        other = ranks[world][r][(case, mesh_shape, t, mode)]
        assert [h["loss"] for h in other["hist"]] == [h["loss"] for h in got["hist"]]
        np.testing.assert_allclose(other["prefill"].numpy(),
                                   want["prefill"][_rows(mesh_shape, r)].numpy(), rtol=RTOL,
                                   atol=RTOL, err_msg=f"{case} {mesh_shape} rank {r}: prefill")


@pytest.mark.parametrize("case,world,mesh_shape,t", BOTH_MODES,
                         ids=[_run_id(*r) for r in BOTH_MODES])
def test_seq_equals_batch_on_the_same_mesh(runs, case, world, mesh_shape, t):
    """``"seq"`` and ``"batch"`` on one mesh: the same run within 1e-5, and
    the last position's prefill logits the same tensor on every rank of a
    model axis (one rank holds that position and sends it)."""
    ranks, base, _, _ = runs
    _assert_run(ranks[world][0][(case, mesh_shape, t, "seq")],
                ranks[world][0][(case, mesh_shape, t, "batch")],
                f"{case} {mesh_shape} T={t} seq vs batch",
                params64=_baseline(base, case, mesh_shape, t)["params64"])
    for r in range(world):
        seq = ranks[world][r][(case, mesh_shape, t, "seq")]
        first = ranks[world][r - r % mesh_shape[1]][(case, mesh_shape, t, "seq")]
        assert torch.equal(seq["prefill"], first["prefill"]), (case, mesh_shape, t, r)


def test_fshard_train_step_on_a_data_axis_equals_the_d_run(runs):
    """A train step through ``moe_ffn_fshard`` with the experts' F-slices on
    two data ranks (2x1: partial products summed; its gradient all-reduced
    back) equals the one-device ``"d"`` run, which routes the whole batch as
    the gathered rows do (2x2 in both modes is in the tests above)."""
    ranks, base, _, _ = runs
    got = ranks[2][0][("jamba_f", *FSHARD_2X1, "batch")]  # (case, mesh, T, mode)
    _assert_run(got, base[("jamba_d", T, False)], "jamba_f 2x1", _rows(FSHARD_2X1[0], 0))
    # not vacuous: the "d" MoE on a data axis of 2 routes each half on its own
    assert base[("jamba_d", T, True)]["hist"][0]["aux"] != got["hist"][0]["aux"]


def test_one_device_step_matches_the_reference(runs):
    """qwen3-8b's one-device first step from the reference's parameters
    (every qwen3 run starts from them: the chain's root) against
    ``repro``'s, on the same batch."""
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.pytree import tree_leaves
    from repro_torch.train.step import make_train_step

    _, _, ref, out = runs
    cfg = _cfg("qwen3", "batch")
    params = _init("qwen3", cfg, str(out))
    opt = adamw_init(params)
    step = make_train_step(Model(cfg, "cpu"), warmup=1, total_steps=4)
    params, opt, m = step(params, opt, _batch(cfg, 0, T))
    for key, want in ref["metrics"].items():
        np.testing.assert_allclose(float(m[key]), want, rtol=REF_TOL, atol=1e-12, err_msg=key)
    got = [x for tree in (params, opt.m, opt.v)
           for x in tree_leaves(lm_params_to_reference(cfg, tree))]
    assert len(got) == len(ref["leaves"])
    for g, w in zip(got, ref["leaves"]):
        g, w = g.double().numpy(), w.astype(np.float64)
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= REF_TOL * max(np.linalg.norm(w), 1e-12)


GATHER_RUNS = [(world, mesh_shape, t) for world, cases in GATHER_CASES.items()
               for mesh_shape, t in cases]


@pytest.mark.parametrize("world,mesh_shape,t", GATHER_RUNS,
                         ids=[_run_id("gather", *r) for r in GATHER_RUNS])
def test_seq_gather_gradient_is_the_reduce_scatter_of_the_sum(runs, world, mesh_shape, t):
    """Every rank gathers the whole sequence; each rank's stripe gets the
    sum over the ranks of its model axis of their gradients of the whole
    sequence (a reduce-scatter), the ranks of another data row apart."""
    ranks, _, _, _ = runs
    n_model = mesh_shape[1]
    for r in range(world):
        got = ranks[world][r][("gather", mesh_shape, t)]
        assert got["whole_equal"]
        row = r // n_model
        total = sum(_gather_weight(t, row * n_model + j) for j in range(n_model))
        assert (got["start"], got["length"]) == stripe(t, n_model, r % n_model)
        want = total.narrow(1, got["start"], got["length"])
        assert torch.equal(got["grad"], want), (mesh_shape, t, r)


@pytest.mark.parametrize("total,n", [(24, 2), (24, 4), (15, 4), (5, 4), (1, 2), (0, 3),
                                     (4096, 16), (7, 7), (3, 8)])
def test_stripe_rule_is_dtensor_shard(total, n):
    """``stripe`` cuts ``total`` positions as DTensor's ``Shard`` (and
    ``torch.chunk``) does: ceil-sized chunks in order, the rest shorter or
    empty, covering every position once."""
    sizes = [c.shape[0] for c in torch.arange(total).chunk(n)] if total else []
    sizes += [0] * (n - len(sizes))
    got = [stripe(total, n, r) for r in range(n)]
    assert [length for _, length in got] == sizes
    assert [start for start, _ in got] == [min(sum(sizes[:r]), total) for r in range(n)]
