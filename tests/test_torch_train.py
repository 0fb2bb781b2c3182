"""The training slice of the PyTorch port against ``repro.train`` on the CPU.

Both packages work on the same arrays (numpy from a seed; model parameters
from the reference's ``Model.init(jax.random.key(0))``, carried over by
``repro_torch.convert.lm_params_from_arrays``). Tolerances:

* AdamW, the schedule, ``token_ce``: float32 rtol 1e-6 (the same float32
  operations in the same order; a transcendental may differ by an ulp, and
  XLA fuses a multiply-add that torch rounds twice, so AdamW's tensors are
  also allowed 1e-6 of their largest entry);
  bfloat16 optimizer states within one bf16 ulp (2^-8 relative), since a
  float32 value an ulp away may round to the neighbouring bf16 value.
* One ``make_train_step`` of a float32 model: loss, its ``ce`` and router
  ``aux`` parts, grad norm and lr rtol 1e-4; new parameters and both
  moments within 1e-4 relative L2 per tensor (elementwise, a gradient entry
  near zero may flip the sign of Adam's normalised step from one summation
  order to another). jamba-v0.1-52b is held over its first step only (lr
  0: its moments carry the clipped gradients, its parameters stay put):
  after clipping, entries of its Mamba ``conv_b`` gradients are about
  2.7e-8, near Adam's eps of 1e-8, where a float32 sum-order difference of
  3e-6 of the tensor's largest entry moves the normalised step by up to 1 %
  (3.9e-4 relative L2 on one tensor after the second step; every gradient
  agrees within 1e-5).
* ``TokenPipeline`` batches, checkpoint leaves and the compression's int8
  arithmetic: ``==``.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.configs as jconfigs
from repro.compat import use_mesh
from repro.launch.train import repro_100m as ref_repro_100m
from repro.models import Axes
from repro.models import Model as JaxModel
from repro.train import checkpoint as ref_ckpt
from repro.train.data import TokenPipeline as RefPipeline
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.schedule import cosine_schedule as ref_cosine
from repro.train.step import make_eval_step as ref_make_eval_step
from repro.train.step import make_train_step as ref_make_train_step
from repro.train.step import token_ce as ref_token_ce
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_arrays, lm_params_to_reference
from repro_torch.launch import elastic
from repro_torch.launch import train as train_mod
from repro_torch.models import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import compress_grads, compressed_psum_pod, init_residuals
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.train.pytree import tree_leaves, tree_map
from repro_torch.train.schedule import cosine_schedule
from repro_torch.train.step import make_eval_step, make_train_step, token_ce

TOL = 1e-4
BF16_ULP = 2.0**-8


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, rtol):
    """Elementwise within ``rtol``, and within ``rtol`` of the tensor's
    largest entry: XLA contracts ``m * b1 + g * (1 - b1)`` into a fused
    multiply-add where torch rounds each product, which shows only where the
    two terms nearly cancel."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


# ------------------------------------------------------------------ optimizer
def _opt_arrays(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "b": rng.standard_normal(16).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.3, 5.0, 0.01)]  # the second step is clipped
    return params, grads


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(state_dtype):
    params, grads = _opt_arrays()
    jp = jax.tree.map(jnp.asarray, params)
    jo = ref_adamw_init(jp, jnp.dtype(state_dtype))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    to = adamw_init(tp, state_dtype)
    assert to.step.dtype == torch.int32 and to.m["w"].dtype == getattr(torch, state_dtype)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, jo, jn = ref_adamw_update(jax.tree.map(jnp.asarray, g), jo, jp, lr)
        tp, to, tn = adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, to, tp, lr)
        assert int(to.step) == int(jo.step) == i + 1
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        state_tol = 1e-6 if state_dtype == "float32" else BF16_ULP
        for k in params:
            for got, want in ((to.m[k], jo.m[k]), (to.v[k], jo.v[k]), (tp[k], jp[k])):
                _close(got, want, state_tol if got is not tp[k] else 1e-6)
            assert to.m[k].dtype == getattr(torch, state_dtype)


def test_global_norm_and_no_clip():
    params, grads = _opt_arrays(1)
    tg = {k: torch.from_numpy(v) for k, v in grads[1].items()}
    want = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in grads[1].values()))
    np.testing.assert_allclose(float(global_norm(tg)), want, rtol=1e-6)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp2, _, _ = ref_adamw_update(jax.tree.map(jnp.asarray, grads[1]), ref_adamw_init(jp), jp,
                                 1e-2, clip_norm=None)
    tp2, _, _ = adamw_update(tg, adamw_init(tp), tp, 1e-2, clip_norm=None)
    for k in params:
        _close(tp2[k], jp2[k], 1e-6)


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 1200, 37, dtype=np.int32)
    for warmup, total in ((100, 1000), (0, 500), (1, 30)):
        want = np.asarray(ref_cosine(jnp.asarray(steps), 3e-4, warmup, total))
        got = cosine_schedule(torch.from_numpy(steps), 3e-4, warmup, total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert float(cosine_schedule(0, 1e-3, 100, 1000)) == 0.0


def test_token_ce_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = float(ref_token_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = token_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------------- data
def test_token_pipeline_batches_equal_reference():
    ref, port = RefPipeline(1000, 64, 4, seed=7), TokenPipeline(1000, 64, 4, seed=7)
    try:
        for _ in range(3):
            a, b = next(ref), next(port)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype == np.int32
                np.testing.assert_array_equal(a[key], b[key])
    finally:
        ref.close()
        port.close()
    for host in (0, 1):
        ref = RefPipeline(500, 32, 8, host_index=host, host_count=2, seed=3)
        port = TokenPipeline(500, 32, 8, host_index=host, host_count=2, seed=3)
        ref.skip_to(5)
        port.skip_to(5)
        a, b = next(ref), next(port)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        ref.close()
        port.close()


# ------------------------------------------------------------------ the step
def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _shrunk_100m(ref: bool):
    base = ref_repro_100m() if ref else train_mod.repro_100m()
    return dataclasses.replace(base, d_model=64, n_blocks=2, n_heads=4, n_kv_heads=2, d_ff=128,
                               vocab_size=256, dtype="float32")


def _configs(arch):
    if arch == "repro-100m":
        return _shrunk_100m(True), _shrunk_100m(False)
    return (dataclasses.replace(jconfigs.get_reduced_config(arch), dtype="float32"),
            dataclasses.replace(tconfigs.get_reduced_config(arch), dtype="float32"))


@functools.cache
def _models(arch):
    jcfg, tcfg = _configs(arch)
    mesh = _mesh()
    jmodel = JaxModel(jcfg, Axes(dp=("data",), tp="model"), mesh)
    with use_mesh(mesh):
        jparams = jmodel.init(jax.random.key(0))
    return jcfg, tcfg, jmodel, jparams, mesh


def _batch(cfg, shape, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (*shape[:-1], shape[-1] + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _ref_steps(arch, batch, steps, accum=1):
    jcfg, _, jmodel, jparams, mesh = _models(arch)
    step = jax.jit(ref_make_train_step(jmodel, warmup=1, total_steps=10, accum=accum))
    p, o, out = jparams, ref_adamw_init(jparams), []
    with use_mesh(mesh):
        for _ in range(steps):
            p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in batch.items()})
            out.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o),
                        {k: float(v) for k, v in m.items()}))
    return out


def _assert_step(tcfg, got, want):
    tp, to, tm = got
    jp, jo, jm = want
    assert set(tm) == {"loss", "ce", "aux", "grad_norm", "lr"}
    for key in tm:
        np.testing.assert_allclose(float(tm[key]), jm[key], rtol=TOL, atol=1e-12)
    assert int(to.step) == int(jo.step)
    for tree, ref_tree in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
        got_leaves = tree_leaves(lm_params_to_reference(tcfg, tree))
        want_leaves = jax.tree.leaves(ref_tree)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            assert tuple(g.shape) == w.shape
            assert _rel_l2(g, w) <= TOL


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b", "repro-100m", "minitron-8b",
                                  "deepseek-coder-33b", "jamba-v0.1-52b", "arctic-480b",
                                  "deepseek-v2-236b"])
def test_train_step_matches_reference(arch):
    """Two steps (warm-up 1: the first at lr 0, the second at the peak);
    one for jamba (the module's docstring says why)."""
    jcfg, tcfg, _, jparams, _ = _models(arch)
    batch = _batch(tcfg, (2, 16))
    want = _ref_steps(arch, batch, 1 if arch == "jamba-v0.1-52b" else 2)
    model = Model(tcfg, "cpu")
    params = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    opt = adamw_init(params)
    step = make_train_step(model, warmup=1, total_steps=10)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for w in want:
        params, opt, metrics = step(params, opt, tb)
        assert all(not t.requires_grad for t in tree_leaves(params))
        _assert_step(tcfg, (params, opt, metrics), w)
    # the eval step reports the reference's loss on the new parameters
    jcfg, _, jmodel, _, mesh = _models(arch)
    with use_mesh(mesh):
        jev = ref_make_eval_step(jmodel)(jax.tree.map(jnp.asarray, want[-1][0]),
                                         {k: jnp.asarray(v) for k, v in batch.items()})
    tev = make_eval_step(model)(params, tb)
    np.testing.assert_allclose(float(tev["loss"]), float(jev["loss"]), rtol=TOL)


def test_train_step_accumulates_microbatches():
    jcfg, tcfg, _, jparams, _ = _models("qwen3-8b")
    batch = _batch(tcfg, (2, 2, 16), seed=4)  # [accum, B, T]
    (want,) = _ref_steps("qwen3-8b", batch, 1, accum=2)
    params = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    step = make_train_step(Model(tcfg, "cpu"), warmup=1, total_steps=10, accum=2)
    got = step(params, adamw_init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(got[2]["aux"]) == 0.0 and float(got[2]["ce"]) == float(got[2]["loss"])
    _assert_step(tcfg, got, want)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_remat_gives_the_same_losses_and_gradients(policy):
    _, tcfg, _, jparams, _ = _models("qwen3-8b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, (2, 16), seed=5).items()}
    params = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    outs = []
    for cfg in (tcfg, dataclasses.replace(tcfg, remat=True, remat_policy=policy)):
        step = make_train_step(Model(cfg, "cpu"), warmup=1, total_steps=10)
        p, o = params, adamw_init(params)
        for _ in range(2):
            p, o, m = step(p, o, batch)
        outs.append((p, o, m))
    (p0, o0, m0), (p1, o1, m1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["grad_norm"]) == float(m1["grad_norm"])
    for a, b in zip(tree_leaves((p0, o0.m, o0.v)), tree_leaves((p1, o1.m, o1.v))):
        assert torch.equal(a, b)


def _moe_block(arch):
    """One block of the reduced MoE config (jamba: its eight-layer period)
    with the port's own seeded weights, and a batch: what the remat tests
    compare against themselves."""
    cfg = dataclasses.replace(tconfigs.get_reduced_config(arch), dtype="float32", n_blocks=1)
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    return cfg, params, {k: torch.from_numpy(v) for k, v in _batch(cfg, (2, 16), seed=5).items()}


def _one_step(cfg, params, batch):
    return make_train_step(Model(cfg, "cpu"), warmup=1, total_steps=10)(
        params, adamw_init(params), batch)


@pytest.mark.parametrize("arch,policy", [
    ("jamba-v0.1-52b", "save_moe"), ("arctic-480b", "save_moe"), ("arctic-480b", "dots"),
    ("arctic-480b", "nothing"),
])
def test_remat_of_moe_layers_gives_the_remat_off_step(arch, policy):
    """Remat over MoE layers (``save_moe``, the reference's policy for
    them, and the other two) gives the step without remat bit for bit: the
    loss with its router part, the grad norm and both moments (which carry
    every gradient)."""
    cfg, params, batch = _moe_block(arch)
    (p0, o0, m0), (p1, o1, m1) = (
        _one_step(c, params, batch)
        for c in (cfg, dataclasses.replace(cfg, remat=True, remat_policy=policy)))
    assert float(m0["aux"]) > 0
    for key in ("loss", "aux", "grad_norm"):
        assert float(m0[key]) == float(m1[key]), key
    for a, b in zip(tree_leaves((p0, o0.m, o0.v)), tree_leaves((p1, o1.m, o1.v))):
        assert torch.equal(a, b)


def test_save_moe_keeps_the_moe_output_only(monkeypatch):
    """Under ``save_moe`` the checkpoint policy sees each MoE layer's
    ``moe_out`` operator and keeps its output (``MUST_SAVE``), and no other
    operator's; the operator itself runs once per MoE layer (the backward
    recomputes a layer only up to its last tensor needed, and never again
    past the kept output)."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as tmodel

    cfg, params, batch = _moe_block("jamba-v0.1-52b")
    cfg = dataclasses.replace(cfg, remat=True, remat_policy="save_moe")
    n_moe = sum(s.ffn in ("moe", "moe_dense") for s in cfg.layers())
    decisions, calls = [], []
    policy = tmodel._POLICIES["save_moe"]

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        decisions.append((op, decision, ctx.is_recompute))
        return decision

    def counting(y):
        calls.append(1)
        return y.clone()

    monkeypatch.setitem(tmodel._POLICIES, "save_moe", recording)
    tlayers.moe_out.register_kernel("cpu")(counting)
    try:
        _one_step(cfg, params, batch)
    finally:
        tlayers.moe_out.register_kernel("cpu")(lambda y: y.clone())
    marker = torch.ops.repro_torch.moe_out.default
    forward = [(op, d) for op, d, rec in decisions if not rec]  # torch >= 2.13 asks only here
    saved = [op for op, d in forward if d == CheckpointPolicy.MUST_SAVE]
    assert saved == [marker] * n_moe and n_moe == 4
    assert len(forward) > 100 * n_moe  # every other operator is recomputed
    assert len(calls) == n_moe


def test_remat_policies_the_port_refuses():
    _, tcfg = _configs("qwen3-8b")
    Model(dataclasses.replace(tcfg, remat=True, remat_policy="save_moe"), "cpu")  # now ported
    with pytest.raises(ValueError, match="unknown remat_policy"):
        Model(dataclasses.replace(tcfg, remat=True, remat_policy="most"), "cpu")


def test_config_fields_and_repro_100m():
    ref, port = ref_repro_100m(), train_mod.repro_100m()
    for name in ("router_aux_weight", "opt_state_dtype", "remat", "remat_policy", "d_model",
                 "vocab_size", "n_blocks", "n_heads", "n_kv_heads", "d_ff", "activation"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.param_count() == ref.param_count() == 88_650_880
    for arch in ("qwen3-8b", "falcon-mamba-7b"):
        for get in ("get_config", "get_reduced_config"):
            r, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
            for name in ("router_aux_weight", "opt_state_dtype", "remat", "remat_policy"):
                assert getattr(t, name) == getattr(r, name), (arch, get, name)


# --------------------------------------------------------------- checkpoints
def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains a step and saves; the port restores and its next
    step is the reference's next step."""
    jcfg, tcfg, jmodel, jparams, mesh = _models("repro-100m")
    batch = _batch(tcfg, (2, 16), seed=6)
    first, second = _ref_steps("repro-100m", batch, 2)
    jp, jo, _ = first
    ref_ckpt.save_checkpoint(str(tmp_path), 1, (jp, jo))
    model = Model(tcfg, "cpu")
    p0 = model.init(torch.Generator().manual_seed(0))
    params, opt, step = train_mod.restore(str(tmp_path), tcfg, p0, adamw_init(p0), "cpu")
    assert step == 1 and int(opt.step) == 1 and opt.step.dtype == torch.int32
    for got, want in zip(tree_leaves(lm_params_to_reference(tcfg, params)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got.numpy(), want)
    out = make_train_step(model, warmup=1, total_steps=10)(
        params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_step(tcfg, out, second)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg, tcfg, jmodel, jparams, mesh = _models("repro-100m")
    model = Model(dataclasses.replace(tcfg, dtype="bfloat16"), "cpu")
    params = model.init(torch.Generator().manual_seed(3))
    opt = adamw_init(params)
    opt = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                     m=tree_map(lambda p: torch.full(p.shape, 0.5), params),
                     v=tree_map(lambda p: torch.full(p.shape, 0.25), params))
    path = ckpt.save_checkpoint(str(tmp_path), 7, train_mod.checkpoint_tree(model.cfg, params,
                                                                            opt))
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert set(manifest) == {"step", "num_leaves", "treedef", "dtypes", "shapes"}
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    jm16 = JaxModel(jcfg16, Axes(dp=("data",), tp="model"), mesh)
    with use_mesh(mesh):
        like_p = jm16.init(jax.random.key(1))
    like = (like_p, ref_adamw_init(like_p))
    (rp, ro), step = ref_ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 7 and int(ro.step) == 7
    got = jax.tree.leaves((rp, ro))
    want = tree_leaves(train_mod.checkpoint_tree(model.cfg, params, opt))
    assert len(got) == len(want) == manifest["num_leaves"]
    for g, w, dtype in zip(got, want, manifest["dtypes"]):
        assert str(np.asarray(g).dtype) == dtype
        np.testing.assert_array_equal(np.asarray(g, np.float32), w.float().numpy())
    assert any(d == "bfloat16" for d in manifest["dtypes"])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "arctic-480b"])
def test_moe_checkpoints_cross_both_ways(tmp_path, arch):
    """A bf16 MoE model's state (the float32 router, ``w_in``/``w_gate``/
    ``w_out`` of ``[n_blocks, E, ...]``, AdamW moments in the config's
    ``opt_state_dtype``: bfloat16 for arctic) saved by the reference
    restores in the port leaf for leaf, and the port's save restores in the
    reference."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in _configs(arch))
    mesh = _mesh()
    jmodel = JaxModel(jcfg, Axes(dp=("data",), tp="model"), mesh)
    with use_mesh(mesh):
        jp = jmodel.init(jax.random.key(2))
    state_dtype = jnp.dtype(jcfg.opt_state_dtype)
    jo = dataclasses.replace(
        ref_adamw_init(jp, state_dtype), step=jnp.int32(3),
        m=jax.tree.map(lambda a: (a * 0.5).astype(state_dtype), jp),
        v=jax.tree.map(lambda a: (a * a).astype(state_dtype), jp))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, (jp, jo))
    model = Model(tcfg, "cpu")
    p0 = model.init(torch.Generator().manual_seed(0))
    assert p0["layers"][1]["moe"]["router"].dtype == torch.float32
    params, opt, step = train_mod.restore(str(tmp_path / "ref"), tcfg, p0,
                                          adamw_init(p0, tcfg.opt_state_dtype), "cpu")
    assert step == 3 and int(opt.step) == 3
    ref_leaves = jax.tree.leaves((jp, jo))
    port_tree = train_mod.checkpoint_tree(tcfg, params, opt)
    assert len(tree_leaves(port_tree)) == len(ref_leaves)
    for got, want in zip(tree_leaves(port_tree), ref_leaves):
        assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    ckpt.save_checkpoint(str(tmp_path / "port"), 4, port_tree)
    (rp, ro), rstep = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), (jp, jo))
    assert rstep == 4
    for got, want in zip(jax.tree.leaves((rp, ro)), ref_leaves):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got, np.float32), np.asarray(want, np.float32))


def test_checkpoint_keep_n_and_atomic_publish(tmp_path):
    tree = {"x": torch.zeros(3), "y": (torch.ones(2, dtype=torch.bfloat16), {"z": 7})}
    for s in range(6):
        ckpt.save_checkpoint(str(tmp_path), s, tree, keep=3)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == [f"step_{s:010d}" for s in (3, 4, 5)]
    # a crash mid-write leaves only a .tmp_ directory: never the latest
    os.makedirs(tmp_path / ".tmp_step_0000000009")
    (tmp_path / ".tmp_step_0000000009" / "leaves.npz").write_bytes(b"half a file")
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, step = ckpt.restore_checkpoint(str(tmp_path), tree)
    assert step == 5 and restored["y"][0].dtype == torch.bfloat16
    assert torch.equal(restored["y"][0], tree["y"][0]) and int(restored["y"][1]["z"]) == 7
    # the next save of that step replaces the stale temporary directory
    ckpt.save_checkpoint(str(tmp_path), 9, tree, keep=3)
    assert not (tmp_path / ".tmp_step_0000000009").exists()
    assert ckpt.latest_step(str(tmp_path)) == 9
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), tree)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(str(tmp_path), {"x": tree["x"]})
    # the reference reads the port's file
    (rtree, rstep) = ref_ckpt.restore_checkpoint(
        str(tmp_path), {"x": np.zeros(3), "y": (np.zeros(2), {"z": 0})})
    assert rstep == 9 and str(rtree["y"][0].dtype) == "bfloat16"


def test_async_checkpointer_snapshots_the_tree(tmp_path):
    tree = {"w": torch.arange(4.0)}
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    saver.save(1, tree)
    tree["w"].add_(100.0)  # training goes on with the buffers
    saver.wait()
    restored, _ = ckpt.restore_checkpoint(str(tmp_path), tree)
    assert torch.equal(restored["w"], torch.arange(4.0))


# --------------------------------------------------------------- compression
def _np_compress(vals):
    """``repro/train/compression.py:36-53`` in numpy float32, for the pods'
    ``grad + residual`` values."""
    n = len(vals)
    amax = np.float32(max(np.abs(v).max() for v in vals))
    scale = amax / np.float32(127.0) + np.float32(1e-12)
    q = [np.clip(np.round(v / scale), -127, 127).astype(np.int8) for v in vals]
    summed = sum(x.astype(np.int32) for x in q)
    deq = summed.astype(np.float32) * scale / np.float32(n)
    return deq, [v - x.astype(np.float32) * scale for v, x in zip(vals, q)], scale


def _compress_rank(rank, world, store, cases, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    try:
        for name, (grads, residuals) in cases.items():
            g = torch.from_numpy(grads[rank])
            r = torch.from_numpy(residuals[rank])
            new_g, new_r = compressed_psum_pod(g, r)
            tree_g, tree_r = compress_grads({"a": g}, {"a": r})
            np.savez(f"{out}_{name}_{rank}.npz", g=new_g.numpy(), r=new_r.numpy(),
                     tg=tree_g["a"].numpy(), tr=tree_r["a"].numpy())
    finally:
        dist.destroy_process_group()


def test_compression_one_pod_is_the_identity():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    r = init_residuals({"g": g})["g"]
    out, new_r = compressed_psum_pod(g, r)
    assert out is g and new_r is r and torch.equal(out, g)


def test_compression_two_pods_over_gloo(tmp_path):
    rng = np.random.default_rng(0)
    same = rng.standard_normal((16, 16)).astype(np.float32)
    cases = {
        "same": ([same, same], [np.zeros_like(same)] * 2),
        "differ": ([rng.standard_normal((16, 16)).astype(np.float32) * s for s in (1.0, 3.0)],
                   [rng.standard_normal((16, 16)).astype(np.float32) * 0.01 for _ in range(2)]),
    }
    out = str(tmp_path / "out")
    torch.multiprocessing.start_processes(
        _compress_rank, args=(2, (tmp_path / "store").as_uri(), cases, out), nprocs=2, join=True,
        start_method="spawn")
    for name, (grads, residuals) in cases.items():
        ranks = [np.load(f"{out}_{name}_{p}.npz") for p in range(2)]
        deq, new_r, scale = _np_compress([g + r for g, r in zip(grads, residuals)])
        for p, res in enumerate(ranks):
            np.testing.assert_array_equal(res["g"], deq)
            np.testing.assert_array_equal(res["r"], new_r[p])
            np.testing.assert_array_equal(res["tg"], res["g"])
            np.testing.assert_array_equal(res["tr"], res["r"])
        if name == "same":  # the reference test's bounds
            ref_scale = float(np.abs(same).max()) / 127.0
            assert float(np.abs(ranks[0]["g"] - same).max()) <= ref_scale + 1e-6
            assert float(np.abs(ranks[0]["r"]).max()) <= ref_scale + 1e-6
        assert float(np.abs(new_r[0]).max()) <= float(scale)


# -------------------------------------------------------------- the drivers
ARGS = ["--arch", "reduced:qwen3-8b", "--steps", "30", "--global-batch", "4", "--seq-len",
        "32", "--ckpt-every", "10", "--log-every", "100", "--device", "cpu"]


def test_train_driver_crash_restart(tmp_path, capsys):
    """The reference's crash-restart check at reduced size: a crash at 15
    leaves step 10; the resumed run ends at 30 with the uninterrupted run's
    losses for steps 11-30 (``==`` on the CPU) and below step 1's."""
    ck = str(tmp_path / "ckpt")
    crashed = []
    with pytest.raises(RuntimeError, match="injected failure"):
        train_mod.main([*ARGS, "--ckpt-dir", ck, "--fail-at", "15"], crashed)
    assert ckpt.latest_step(ck) == 10 and len(crashed) == 15
    resumed = []
    loss = train_mod.main([*ARGS, "--ckpt-dir", ck], resumed)
    assert "[restore] resumed from step 10" in capsys.readouterr().out
    assert ckpt.latest_step(ck) == 30 and [h["step"] for h in resumed] == list(range(11, 31))
    whole = []
    train_mod.main(ARGS, whole)
    assert [h["loss"] for h in resumed] == [h["loss"] for h in whole[10:]]
    assert [h["loss"] for h in crashed[:15]] == [h["loss"] for h in whole[:15]]
    assert np.isfinite(loss) and loss == whole[-1]["loss"] < whole[0]["loss"]


def test_elastic_demo_and_mesh_errors(tmp_path):
    loss = elastic.main(["--ckpt-dir", str(tmp_path), "--steps", "20", "--arch",
                         "reduced:falcon-mamba-7b", "--device", "cpu"])
    assert np.isfinite(loss) and ckpt.latest_step(str(tmp_path)) == 20
    with pytest.raises(NotImplementedError, match="item 8d"):
        train_mod.main([*ARGS, "--mesh", "1x2"])
    with pytest.raises(NotImplementedError, match="item 8d"):
        train_mod.check_mesh("2x2x2")


def test_train_driver_defaults_to_the_card(tmp_path):
    """``--device`` defaults to ``cuda``: without a card the driver raises
    and names the CPU, never training there unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    args = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_mod.main(args)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        elastic.main(["--steps", "2", "--ckpt-dir", str(tmp_path)])
