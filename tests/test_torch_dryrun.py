"""The port's dry run and op analysis (``launch/op_analysis.py``,
``launch/dryrun.py``) against the reference's HLO analysis (ROADMAP
Queue 1 item 8d).

``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS`` when
imported. The reference's counts come from ``repro.launch.hlo_analysis.
analyze`` of its compiled steps on a 1x1 mesh, built as
``tests/test_models_smoke.py`` builds them.

Tolerance of the per-shard dot FLOPs on a 1x1 mesh (the ten reduced
configs, train / prefill / decode; hubert-xlarge has no decode step): 2 %
relative. Both count every matmul of the step, the attention's score and
value products included, forward and backward; the reference gets the
inputs the port's dry run gives (frames, image embeddings). What differs:
the reference's Mamba scan has one dot of its own (``bcdn,bcn->bcd``, the
readout of the state), which the port's scan kernel does not have (its
readout is a multiply-sum), so the port is held to the reference's count
less those dots (``_readout_flops``; falcon-mamba-7b read 0.972-0.981 of
the whole count); and XLA may fold or split a few small products (the
router's, the absorbed projections'). The tensor-parallel meshes' counts
are ``tests/test_torch_tensor_parallel.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import repro.configs as jconfigs
from repro.compat import use_mesh
from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro.models import Axes as JAxes
from repro.models import Model as JModel
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.step import make_decode_step as jax_decode_step
from repro.train.step import make_prefill_step as jax_prefill_step
from repro.train.step import make_train_step as jax_train_step
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import COLLECTIVE_OPS, OpCounter, analyze

SHAPES = {
    "train": dict(seq_len=64, global_batch=4, kind="train"),
    "prefill": dict(seq_len=64, global_batch=4, kind="prefill"),
    "decode": dict(seq_len=64, global_batch=4, kind="decode"),
}
DOT_RTOL = 0.02


def test_loop_of_five_matmuls_counts_like_the_reference_scan():
    """The reference's case (tests/test_extensions.py): a scan of 5
    ``[64, 32] @ [32, 32]`` gives exactly ``2*64*32*32*5`` dot FLOPs and
    trip count 5; the port runs the loop and counts it."""

    def f(x, w):
        for _ in range(5):
            x = x @ w
        return x

    x, w = torch.randn(64, 32), torch.randn(32, 32)
    res = analyze(f, x, w)
    assert res["dot_flops_per_shard"] == 2 * 64 * 32 * 32 * 5
    assert res["max_trip_count"] == 5
    assert res["total_collective_bytes"] == 0.0 and res["collective_counts"] == {}
    torch.testing.assert_close(res["result"], f(x, w))
    assert analyze(f, x, w, trip_count=3)["max_trip_count"] == 3


def test_repeat_counts_a_body_n_times():
    counter = OpCounter()
    x = torch.randn(8, 4)
    with counter:
        with counter.repeat(7):
            x @ x.T
    assert counter.flops == 7 * 2 * 8 * 4 * 8


def _reference_flops(arch: str, kind: str) -> float:
    """The reference's per-shard dot FLOPs of one step on a 1x1 mesh, with
    the inputs the port's dry run gives (``repro.launch.specs.batch_specs``:
    frames or tokens, labels, image embeddings)."""
    from repro.launch.specs import batch_specs as ref_batch_specs

    cfg = jconfigs.get_reduced_config(arch)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    model = JModel(cfg, JAxes(dp=("data",), tp="model"), mesh)
    shape = SHAPES[kind]
    b, s = shape["global_batch"], shape["seq_len"]
    params = jax.eval_shape(model.init, jax.random.key(0))
    sds = jax.ShapeDtypeStruct
    with use_mesh(mesh):
        if kind == "train":
            opt = jax.eval_shape(lambda p: jax_adamw_init(p, jnp.dtype(cfg.opt_state_dtype)),
                                 params)
            batch = ref_batch_specs(cfg, shape, mesh, ("data",))
            lowered = jax.jit(jax_train_step(model)).lower(params, opt, batch)
        elif kind == "prefill":
            lowered = jax.jit(jax_prefill_step(model)).lower(
                params, ref_batch_specs(cfg, shape, mesh, ("data",)))
        else:
            cache = jax.eval_shape(lambda: model.init_cache(b, s))
            lowered = jax.jit(jax_decode_step(model)).lower(
                params, cache, sds((b, 1), jnp.int32), sds((), jnp.int32))
        hlo = lowered.compile().as_text()
    return hlo_analyze(hlo)["dot_flops_per_shard"]


def _port_counts(arch: str, kind: str, mesh_shape=(1, 1)) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(mesh_shape)))
    try:
        mesh = dryrun._mesh(False, mesh_shape)
        counter = OpCounter()
        with FakeTensorMode(), dryrun.shape_only_scan():
            step, args, _, _ = dryrun.lower_cell(f"reduced:{arch}", SHAPES[kind], False, None,
                                                 mesh, counter)
            res = analyze(step, *args, counter=counter)
    finally:
        dist.destroy_process_group()
    return res


ARCHS = ["qwen3-8b", "jamba-v0.1-52b", "falcon-mamba-7b", "minitron-8b", "deepseek-coder-33b",
         "arctic-480b", "gemma3-12b", "llama-3.2-vision-90b", "hubert-xlarge", "deepseek-v2-236b"]


def _readout_flops(arch: str, kind: str) -> float:
    """The dots of the reference's scan readout (``bcdn,bcn->bcd``, ``2 B T
    Di N`` a Mamba layer's forward, three dots a layer in training), which
    the port's scan kernel does as a multiply-sum; none in a decode step,
    whose readout is a dot in both packages."""
    cfg = jconfigs.get_reduced_config(arch)
    if kind == "decode":
        return 0.0
    layers = sum(s.mixer == "mamba" for s in cfg.layers())
    b, t = SHAPES[kind]["global_batch"], SHAPES[kind]["seq_len"]
    per = 2 * b * t * cfg.mamba_expand * cfg.d_model * cfg.ssm_state
    return layers * per * (3 if kind == "train" else 1)


# every (arch, kind) with a step: hubert-xlarge, encoder-only, has no decode
CASES = [(a, k) for a in ARCHS for k in ("train", "prefill", "decode")
         if not (k == "decode" and a == "hubert-xlarge")]


@pytest.mark.parametrize("arch,kind", CASES, ids=[f"{a}-{k}" for a, k in CASES])
def test_dot_flops_on_1x1_match_the_reference_hlo(arch, kind):
    ref = _reference_flops(arch, kind)
    want = ref - _readout_flops(arch, kind)
    got = _port_counts(arch, kind)["dot_flops_per_shard"]
    assert want > 0
    assert abs(got - want) <= DOT_RTOL * ref, (got, want, got / want)


def test_1x1_mesh_moves_nothing_and_2x2_gathers():
    """On a 1x1 mesh the gathers move no bytes between ranks but still run
    (a gather of one shard is its whole); on 2x2 the train step's weight
    all-gathers, gradient reduce-scatters and metric all-reduces appear."""
    one = _port_counts("qwen3-8b", "train", (1, 1))
    four = _port_counts("qwen3-8b", "train", (2, 2))
    assert set(four["collective_counts"]) <= set(COLLECTIVE_OPS)
    assert four["collective_counts"]["all-gather"] > 0
    assert four["collective_counts"]["reduce-scatter"] > 0
    assert four["collective_counts"]["all-reduce"] > 0
    # a data axis of 2 halves the rows each rank multiplies
    assert four["dot_flops_per_shard"] < one["dot_flops_per_shard"]


# the reference's record keys (repro/launch/dryrun.py run_cell) that keep
# their meaning in the port; its compile_s and XLA cost analysis have no
# counterpart (the port traces, it does not compile), nor its memory_s_upper
REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "chips", "accum", "lower_s", "memory",
                  "dot_flops_per_shard", "dot_flops_total", "collective_bytes_per_shard",
                  "collective_counts", "total_collective_bytes_per_shard", "max_trip_count",
                  "model_flops", "tokens", "active_params", "roofline", "wall_s"}
ROOFLINE_KEYS = {"compute_s", "collective_s", "model_flops_ratio"}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_fake_2x2_cell_has_the_reference_keys_and_leaves_no_group(shape, tmp_path):
    """One cell per kind at the real input shapes on a fake 2x2 group
    (reduced jamba: attention, Mamba and MoE layers)."""
    res = dryrun.run_cell("reduced:jamba-v0.1-52b", shape, False, peak=False,
                          mesh_shape=(2, 2))
    assert not dist.is_initialized()
    assert res["status"] == "ok", res.get("traceback")
    assert REFERENCE_KEYS <= set(res) and ROOFLINE_KEYS <= set(res["roofline"])
    assert res["mesh"] == "2x2" and res["chips"] == 4
    assert res["max_trip_count"] == jconfigs.get_reduced_config("jamba-v0.1-52b").n_blocks
    assert res["dot_flops_total"] == 4 * res["dot_flops_per_shard"] > 0
    assert res["memory"]["argument_bytes"] > 0
    assert res["total_collective_bytes_per_shard"] == sum(
        res["collective_bytes_per_shard"].values())
    cfg = dryrun._config("reduced:jamba-v0.1-52b", None)[0]
    assert res["model_flops"] == dryrun.analytic_model_flops(
        cfg, jconfigs.SHAPES[shape], jconfigs.SHAPES[shape]["kind"])["model_flops"]


def test_skipped_cell_and_errors_leave_no_group():
    """A skipped cell, a sequence-parallel cell on a model axis of 2 (it
    lowers: the model axis splits the products in both modes, so a shard's
    dot FLOPs are the batch cell's within 10 %), and a config the port
    refuses each leave no process group behind."""
    res = dryrun.run_cell("qwen3-8b", "long_500k", False)
    assert res["status"] == "skip: pure full-attention arch (needs sub-quadratic)"
    assert not dist.is_initialized()
    cells = {mode: dryrun.run_cell("reduced:qwen3-8b", "train_4k", False,
                                   {"activation_partitioning": mode}, peak=False,
                                   mesh_shape=(2, 2)) for mode in ("seq", "batch")}
    assert not dist.is_initialized()
    assert cells["seq"]["status"] == cells["batch"]["status"] == "ok", cells["seq"].get("error")
    seq, batch = (cells[m]["dot_flops_per_shard"] for m in ("seq", "batch"))
    assert abs(seq - batch) <= 0.1 * batch
    bad = dryrun.run_cell("reduced:qwen3-8b", "train_4k", False,
                          {"activation_partitioning": "tokens"}, peak=False, mesh_shape=(2, 2))
    assert bad["status"] == "error" and "activation_partitioning" in bad["error"]
    assert not dist.is_initialized()


def test_op_analysis_counts_a_stripe_against_the_gathered_keys():
    """Under ``activation_partitioning="seq"`` on a model axis of 2 (fake
    group, shapes only), rank 0 holds a stripe of T/2 positions and each
    region gathers the stripes whole: its attention scores are its own
    query heads (H/2, reading its KV head, group 2) against all T keys,
    a launch a layer (and the backward's recompute of the plain version),
    the same count as the whole sequence's heads over the model axis. Each
    layer's two regions all-gather the normed stripes (``[B, T, D]``, from
    the attention and FFN code) and reduce-scatter their partial outputs
    back (float32 partials: the stripe's ``[B, T/2, D]`` at four bytes),
    and the backward's reduce-scatters of the gathers appear."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    import repro_torch.configs as tconfigs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import batch_specs, sds_tree
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(tconfigs.get_reduced_config("qwen3-8b"),
                              activation_partitioning="seq")
    b, t = 2, 64
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = make_debug_mesh(1, 2)
        model = Model(cfg, "cpu", mesh=mesh)
        with FakeTensorMode():
            params = sds_tree(model.init_shapes(), model.param_specs(), mesh)
            batch = batch_specs(cfg, {"global_batch": b, "seq_len": t}, mesh, ("data",))
            res = analyze(make_train_step(model), params, adamw_init(params), batch,
                          sources=True)
    finally:
        dist.destroy_process_group()
    dh = cfg.head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    n_attn = sum(s.mixer == "attn" for s in cfg.layers())
    dots = res["counter"].dots
    assert dots[("bmm", ((b, g * t, dh), (b, dh, t)))] == 2 * n_attn
    assert not any(sig[0] == "bmm" and sig[1][0][1] == 2 * g * t for sig in dots)
    whole = b * t * cfg.d_model * 2  # a [B, T, D] bf16 activation
    for src in ("models/attention.py", "models/layers.py"):
        gathers = [r for r in res["counter"].records
                   if r[0] == "all-gather" and (r[3] or "").startswith(src)]
        scatters = [r for r in res["counter"].records
                    if r[0] == "reduce-scatter" and (r[3] or "").startswith(src)]
        assert len(gathers) == n_attn and all(r[1] == whole for r in gathers), src
        assert len(scatters) == n_attn and all(r[1] == whole for r in scatters), src
    assert res["collective_counts"]["reduce-scatter"] > 2 * n_attn


def test_peak_bytes_from_memtracker():
    res = dryrun.run_cell("reduced:qwen3-8b", "decode_32k", False, mesh_shape=(2, 2))
    assert res["status"] == "ok"
    mem = res["memory"]
    assert mem["peak_note"] is None and mem["peak_bytes"] >= mem["argument_bytes"] > 0


def test_main_writes_one_file_per_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    path = tmp_path / "hubert_xlarge_decode_32k_single.json"
    import json

    rec = json.loads(path.read_text())
    assert rec["status"] == "skip: encoder-only arch has no decode step"
    assert "[done] hubert_xlarge_decode_32k_single" in capsys.readouterr().out
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    assert "[skip cached]" in capsys.readouterr().out


def test_importing_the_dry_run_changes_nothing():
    """Unlike the reference's module, the port's sets no ``XLA_FLAGS`` and
    makes no process group when imported (a fresh interpreter)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import os, torch.distributed as dist\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "assert dict(os.environ) == before\n"
            "assert not dist.is_initialized()\n")
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(root / "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
