"""Tensor-parallel products on the model axis against the reference (ROADMAP
Queue 1 item 8f): column- and row-parallel attention, MLA, the dense FFN,
Mamba and the vocabulary-parallel head, as the ``specs_*`` place the
weights, on the CPU.

Three parts:

* In one process, no group: each module gets its rank-r shards (the
  reference's float32 weights from ``Model.init(jax.random.key(0))``,
  carried over by ``convert.lm_params_from_arrays`` and cut as
  ``specs_layer`` places them on a model axis of n) for each simulated
  rank, one thread a rank. ``SimAxis`` stands in for
  ``launch.mesh.ModelAxis``: its sums add the ranks' partial outputs, its
  gathers concatenate their chunks, as the collectives would. Every rank's
  output is held against the reference's function on the whole weights at
  1e-5 (relative and absolute, float32). Cases: reduced qwen3-8b's dense
  FFN and attention (n=2: whole KV heads; n=4: two KV heads over four
  ranks, K and V gathered), repro-100m's attention (n=2: 5 x 64 KV columns
  are 2.5 heads a rank; a launch's query heads read one KV head each),
  reduced llama-3.2-vision's gated cross-attention (the gate set to 0.5),
  reduced deepseek-v2's MLA, reduced falcon-mamba's mixer and its decode
  step (n=2, 4: ``in_proj``'s chunk exchanged for the rank's channels both
  ways, by weights and by products), and the embedding, head and
  vocabulary-parallel cross-entropy (n=2, 4).
* Dot FLOPs a shard: the port's dry run (``launch/dryrun.py`` on a fake
  group) against ``repro.launch.hlo_analysis`` of the reference's
  compiled steps on 1x2, 2x2 and 1x4, reduced qwen3-8b and jamba, train,
  prefill and decode at B=4, T=64, within ``DOT_RTOL`` = 2 %; jamba's port
  count is held to the reference's less its scan readout dots (see
  ``tests/test_torch_dryrun.py``). The reference's counts come from one
  child process with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
  (the flag never reaches this process). qwen3's 2x2 train and prefill
  steps are ``xfail(strict=True)``: the reference's GSPMD runs the
  attention's score and value products (``bthgd,bshd->bhgts``,
  ``bhgts,bshd->bthgd``) split two ways on 2x2 (``[4, 64, 128]`` a layer,
  half the 1x1 dot) where the port splits them four ways (its data rank's
  rows, its model rank's heads), so its count is 0.923 of the reference's
  (ROADMAP Queue 3).
* Values on gloo ranks (two spawns, one at a time: 4 ranks, then 2), what
  ``tests/test_torch_sharded_train.py`` and ``tests/test_torch_seq_parallel.
  py`` lack: a KV head count the model axis does not divide (reduced qwen3
  on 1x4), MLA (reduced deepseek-v2 on 1x2), cross-attention (reduced
  llama-3.2-vision on 1x2, with image embeddings) and pure Mamba (reduced
  falcon-mamba on 1x2). Each rank's loss and every gradient (gathered
  whole) of one float32 step at B=4, T=16, against the one-device run in
  this process: the loss at rtol 1e-5, the whole gradient at 1e-5 relative
  L2 and each leaf's difference within 1e-5 of the whole gradient's norm
  (a leaf that is one sum of many terms, such as llama's gate, reads 2e-5
  of its own norm off: the ranks' partial sums add in another order);
  then ``launch.serve --mesh`` greedy tokens (bf16, B=4, prompt 3, 3
  tokens) ``==`` the one-device loop's.

Alone this file takes about 3.7 minutes on a few cores (the reference's 18
compiles in the child 140 s, the two spawns of ranks about 20 s).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import repro.configs as jconfigs
from repro.compat import use_mesh
from repro.launch.train import repro_100m as ref_repro_100m
from repro.models import Axes as JAxes
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import dryrun
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.op_analysis import OpCounter, analyze
from repro_torch.launch.specs import sanitize_spec
from repro_torch.launch.train import repro_100m
from repro_torch.models import attention as tattn
from repro_torch.models import mamba as tmamba
from repro_torch.models.layers import Axes, dense_ffn
from repro_torch.models.model import Model, specs_layer
from repro_torch.train.step import token_nll

TOL = 1e-5
DOT_RTOL = 0.02
RTOL = 1e-5


# ------------------------------------------------- a model axis of threads
class _Hub:
    def __init__(self, n: int):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)


class SimAxis:
    """``launch.mesh.ModelAxis``'s collectives among ``n`` threads of this
    process, one a simulated rank (forward only), handed to a split region:
    a sum adds the ranks' tensors in rank order, a gather concatenates
    them, ``channels`` assembles this rank's channels of both halves from
    the ranks' chunks."""

    def __init__(self, hub: _Hub, rank: int, split: bool = True):
        self.hub, self.rank, self.size, self.stripe = hub, rank, hub.n, None
        self.split = split

    def region(self, split):
        return SimAxis(self.hub, self.rank, split)

    def _swap(self, t: torch.Tensor) -> list:
        self.hub.slots[self.rank] = t
        self.hub.barrier.wait()
        out = list(self.hub.slots)
        self.hub.barrier.wait()
        return out

    def enter(self, h):
        return h

    def exit(self, y):
        return self.sum(y) if self.split else y

    def sum(self, y, grad_sum=False):
        parts = self._swap(y)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def gather(self, x, dim, grad_sum=True):
        return torch.cat(self._swap(x), dim)

    def max(self, x):
        return torch.stack(self._swap(x)).amax(0)

    def channels(self, w):
        whole = torch.cat(self._swap(w), 1)
        half, c = whole.shape[1] // 2, whole.shape[1] // 2 // self.size
        r = self.rank
        return torch.cat([whole[:, r * c:(r + 1) * c], whole[:, half + r * c:half + (r + 1) * c]], 1)


def on_ranks(n: int, fn) -> list:
    """``fn(axis)`` on ``n`` simulated ranks (threads); their results."""
    hub = _Hub(n)
    out, errors = [None] * n, []

    def run(r):
        try:
            with torch.no_grad():
                out[r] = fn(SimAxis(hub, r))
        except BaseException as err:  # noqa: BLE001 - re-raised below
            errors.append(err)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


class _Sizes:
    def __init__(self, n: int):
        self.shape = {"data": 1, "model": n}


def shard(full: torch.Tensor, spec, n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s shard of ``full`` under the sanitised ``spec`` on a
    1 x n mesh."""
    spec = sanitize_spec(full.shape, spec, _Sizes(n))
    for dim, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            step = full.shape[dim] // n
            full = full.narrow(dim, r * step, step)
    return full


def shard_tree(tree: dict, specs: dict, n: int, r: int) -> dict:
    return {k: shard_tree(v, specs[k], n, r) if isinstance(v, dict) else shard(v, specs[k], n, r)
            for k, v in tree.items()}


# -------------------------------------------------------------- the models
def _models(arch: str):
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(arch), dtype="float32")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jparams = JModel(jcfg, JAxes(dp=("data",), tp="model"), mesh).init(jax.random.key(0))
    tparams = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams, mesh


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _models(arch)
        return cache[arch]

    return get


def _layer(jparams, tparams, tcfg, position: int):
    """Block 0's layer ``position``: the reference's (its stacked leaves'
    first entry) and the port's, with the port's layer spec."""
    j = jax.tree.map(lambda a: a[0], jparams["blocks"][position])
    i = len(tcfg.prefix) + position
    return j, tparams["layers"][i], tcfg.layers()[i]


def _x(cfg, b=2, t=12, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, t, cfg.d_model)) * scale) \
        .astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


# -------------------------------------------------------- in-process shards
@pytest.mark.parametrize("n", [2, 4])
def test_dense_ffn_shards_sum_to_the_reference(models, n):
    jcfg, jparams, tcfg, tparams, mesh = models("qwen3-8b")
    jl, tl, spec = _layer(jparams, tparams, tcfg, 0)
    specs = specs_layer(spec, tcfg, Axes())["ffn"]
    x = _x(tcfg, seed=1)
    want = jlayers.dense_ffn(jnp.asarray(x), jl["ffn"], jcfg.activation)
    outs = on_ranks(n, lambda ax: dense_ffn(torch.from_numpy(x),
                                            shard_tree(tl["ffn"], specs, n, ax.rank),
                                            tcfg.activation, ax))
    for y in outs:
        _close(y, want)


def _attention_case(arch_or_cfg, models):
    if arch_or_cfg == "repro-100m":  # its own config, one attention layer
        jcfg = dataclasses.replace(ref_repro_100m(), dtype="float32")
        tcfg = dataclasses.replace(repro_100m(), dtype="float32")
        jp = jattn.init_attention(jax.random.key(1), jcfg, jnp.float32)
        tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
        return jcfg, tcfg, jp, tp, Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                        ("data", "model"))
    jcfg, jparams, tcfg, tparams, mesh = models(arch_or_cfg)
    jl, tl, _ = _layer(jparams, tparams, tcfg, 0)
    return jcfg, tcfg, jl["attn"], tl["attn"], mesh


@pytest.mark.parametrize("arch,n", [("qwen3-8b", 2), ("qwen3-8b", 4), ("repro-100m", 2)])
def test_gqa_shards_sum_to_the_reference(models, arch, n):
    """A rank's query heads against the KV heads they read: whole KV chunks
    (qwen3, n=2), half a KV head a rank gathered (qwen3, n=4), and 2.5 KV
    heads a rank whose launch reads one KV head a query head (repro-100m)."""
    jcfg, tcfg, jp, tp, mesh = _attention_case(arch, models)
    specs = tattn.specs_attention(tcfg, Axes())
    x = _x(tcfg, seed=2, scale=0.5)
    with use_mesh(mesh):
        want, _ = jattn.gqa_forward(jnp.asarray(x), jp, jcfg, window=None)
    outs = on_ranks(n, lambda ax: tattn.gqa_forward(
        torch.from_numpy(x), shard_tree(tp, specs, n, ax.rank), tcfg, window=None, tp=ax)[0])
    for y in outs:
        _close(y, want)


def test_cross_attention_shards_sum_then_gate(models):
    """llama-3.2-vision's gated cross-attention layer (block position 4) on
    two ranks, the gate at 0.5 in both packages, applied after the sum."""
    jcfg, jparams, tcfg, tparams, mesh = models("llama-3.2-vision-90b")
    jl, tl, spec = _layer(jparams, tparams, tcfg, 4)
    assert spec.mixer == "cross_attn"
    jp = dict(jl["attn"], gate=jnp.full((1,), 0.5, jnp.float32))
    tp = dict(tl["attn"], gate=torch.full((1,), 0.5))
    specs = tattn.specs_attention(tcfg, Axes(), cross=True)
    x, img = _x(tcfg, seed=3, scale=0.5), _x(tcfg, t=tcfg.n_img_tokens, seed=4, scale=0.5)
    with use_mesh(mesh):
        want, _ = jattn.gqa_forward(jnp.asarray(x), jp, jcfg, window=None, kv_x=jnp.asarray(img))
    outs = on_ranks(2, lambda ax: tattn.gqa_forward(
        torch.from_numpy(x), shard_tree(tp, specs, 2, ax.rank), tcfg, window=None,
        kv_x=torch.from_numpy(img), tp=ax)[0])
    for y in outs:
        _close(y, want)


@pytest.mark.parametrize("n", [2, 4])
def test_mla_shards_sum_to_the_reference(models, n):
    """deepseek-v2's MLA: the latent whole on every rank, H / n heads a
    launch, ``wo``'s row chunk summed."""
    jcfg, jparams, tcfg, tparams, mesh = models("deepseek-v2-236b")
    jl, tl, _ = _layer(jparams, tparams, tcfg, 0)
    specs = tattn.specs_attention(tcfg, Axes())
    x = _x(tcfg, seed=5, scale=0.5)
    with use_mesh(mesh):
        want, _ = jattn.mla_forward(jnp.asarray(x), jl["attn"], jcfg)
    outs = on_ranks(n, lambda ax: tattn.mla_forward(
        torch.from_numpy(x), shard_tree(tl["attn"], specs, n, ax.rank), tcfg, tp=ax)[0])
    for y in outs:
        _close(y, want)


@pytest.mark.parametrize("t", [12, 200])  # by products (B T < D), by weights
@pytest.mark.parametrize("n", [2, 4])
def test_mamba_shards_sum_to_the_reference(models, n, t):
    """falcon-mamba's mixer on n ranks' channels (``in_proj``'s chunk
    exchanged for them: by the products at 24 tokens, by the weight at 400),
    and one decode step from channel-split states."""
    jcfg, jparams, tcfg, tparams, mesh = models("falcon-mamba-7b")
    jl, tl, spec = _layer(jparams, tparams, tcfg, 0)
    specs = tmamba.specs_mamba(Axes())
    x = _x(tcfg, t=t, seed=6)
    want, (jconv, _) = jmamba.mamba_forward(jnp.asarray(x), jl["mamba"], jcfg)
    outs = on_ranks(n, lambda ax: tmamba.mamba_forward(
        torch.from_numpy(x), shard_tree(tl["mamba"], specs, n, ax.rank), tcfg, tp=ax))
    for y, _ in outs:
        _close(y, want)
    _close(torch.cat([conv for _, (conv, _) in outs], -1), jconv)
    di = tcfg.mamba_expand * tcfg.d_model
    state = np.random.default_rng(7).standard_normal((2, di, tcfg.ssm_state)).astype(np.float32)
    want, (jconv2, jssm2) = jmamba.mamba_decode_step(jnp.asarray(x[:, :1]), jl["mamba"], jcfg,
                                                     jconv, jnp.asarray(state))
    conv = torch.from_numpy(np.array(jconv))
    outs = on_ranks(n, lambda ax: tmamba.mamba_decode_step(
        torch.from_numpy(x[:, :1]), shard_tree(tl["mamba"], specs, n, ax.rank), tcfg,
        conv.chunk(n, -1)[ax.rank], torch.from_numpy(state).chunk(n, 1)[ax.rank], tp=ax))
    for y, _ in outs:
        _close(y, want)
    _close(torch.cat([c for _, (c, _) in outs], -1), jconv2)
    _close(torch.cat([s for _, (_, s) in outs], 1), jssm2)


@pytest.mark.parametrize("n", [2, 4])
def test_vocabulary_parallel_embedding_head_and_loss(models, n):
    """The embedding's masked lookups summed, each rank's logits the
    reference's vocabulary columns, and the vocabulary-parallel
    cross-entropy the reference's ``token_ce`` terms."""
    jcfg, jparams, tcfg, tparams, _ = models("qwen3-8b")
    model = Model(tcfg, "cpu")
    specs = model.param_specs()
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 12))
    labels = rng.integers(0, tcfg.vocab_size, (2, 12))
    x = _x(tcfg, seed=9)
    emb = np.asarray(jparams["embed"])[tokens]
    h = jlayers.rms_norm(jnp.asarray(x), jparams["final_norm"])
    logits = h @ jparams["unembed"]
    nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, -1), jnp.asarray(labels)[..., None], -1)

    def rank(ax):
        p = {k: shard(v, specs[k], n, ax.rank) if not isinstance(v, (dict, list)) else v
             for k, v in tparams.items()}
        e = model._embed(p, torch.from_numpy(tokens), (), ax)
        lg = model._head(p, torch.from_numpy(x), (), ax)
        return e, lg, token_nll(lg, torch.from_numpy(labels), ax)

    outs = on_ranks(n, rank)
    cols = tcfg.vocab_size // n
    for r, (e, lg, got) in enumerate(outs):
        _close(e, emb)
        _close(lg, np.asarray(logits)[..., r * cols:(r + 1) * cols])
        _close(got, nll)


# ------------------------------------------------ dot FLOPs against the HLO
SHAPES = {k: dict(seq_len=64, global_batch=4, kind=k) for k in ("train", "prefill", "decode")}
FLOP_ARCHS = ("qwen3-8b", "jamba-v0.1-52b")
FLOP_MESHES = ((1, 2), (2, 2), (1, 4))
# the cells where the reference's GSPMD splits a product fewer ways than the
# port (the module's docstring; ROADMAP Queue 3)
GSPMD_ATTENTION_2X2 = ("the reference's GSPMD splits the attention score and value products "
                       "(bthgd,bshd->bhgts, bhgts,bshd->bthgd) two ways on 2x2, the port four")
XFAIL = {("qwen3-8b", "train", (2, 2)), ("qwen3-8b", "prefill", (2, 2))}

REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    import repro.configs as jconfigs
    from repro.compat import use_mesh
    from repro.launch.hlo_analysis import analyze
    from repro.launch.specs import batch_specs, sds, sds_tree
    from repro.models import Axes, Model
    from repro.train.optimizer import adamw_init, adamw_state_specs
    from repro.train.step import make_decode_step, make_prefill_step, make_train_step

    cells = json.loads(sys.argv[1])
    out = {}
    for arch, kind, shape, b, s in cells:
        cfg = jconfigs.get_reduced_config(arch)
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                    ("data", "model"))
        model = Model(cfg, Axes(dp=("data",), tp="model"), mesh)
        params = sds_tree(model.init_shapes(), model.param_specs(), mesh)
        cell = dict(seq_len=s, global_batch=b, kind=kind)
        with use_mesh(mesh):
            if kind == "train":
                opt = jax.eval_shape(lambda p: adamw_init(p, jnp.dtype(cfg.opt_state_dtype)),
                                     params)
                opt = sds_tree(opt, adamw_state_specs(model.param_specs()), mesh)
                lowered = jax.jit(make_train_step(model)).lower(
                    params, opt, batch_specs(cfg, cell, mesh, ("data",)))
            elif kind == "prefill":
                lowered = jax.jit(make_prefill_step(model)).lower(
                    params, batch_specs(cfg, cell, mesh, ("data",)))
            else:
                cache = sds_tree(jax.eval_shape(lambda: model.init_cache(b, s)),
                                 model.cache_specs(), mesh)
                lowered = jax.jit(make_decode_step(model)).lower(
                    params, cache, sds((b, 1), jnp.int32, P(("data",), None), mesh),
                    sds((), jnp.int32, P(), mesh))
            hlo = lowered.compile().as_text()
        out[f"{arch}|{kind}|{shape[0]}x{shape[1]}"] = analyze(hlo)["dot_flops_per_shard"]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_flops():
    """The reference's per-shard dot FLOPs of every cell, from one child."""
    cells = [(a, k, list(m), SHAPES[k]["global_batch"], SHAPES[k]["seq_len"])
             for a in FLOP_ARCHS for k in SHAPES for m in FLOP_MESHES]
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT, json.dumps(cells)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_flops(arch: str, kind: str, mesh_shape) -> float:
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
            return float(analyze(step, *args, counter=counter)["dot_flops_per_shard"])
    finally:
        dist.destroy_process_group()


def _readout_flops(arch: str, kind: str, data: int) -> float:
    """The reference's scan readout dots a shard (``bcdn,bcn->bcd``; the
    port's scan reads out with a multiply-sum), over the model axis as the
    reference splits its channels."""
    cfg = jconfigs.get_reduced_config(arch)
    if kind == "decode":
        return 0.0
    layers = sum(s.mixer == "mamba" for s in cfg.layers())
    b, t = SHAPES[kind]["global_batch"] // data, SHAPES[kind]["seq_len"]
    per = 2 * b * t * cfg.mamba_expand * cfg.d_model * cfg.ssm_state
    return layers * per * (3 if kind == "train" else 1)


FLOP_CASES = [pytest.param(a, k, m, id=f"{a}-{k}-{m[0]}x{m[1]}",
                           marks=[pytest.mark.xfail(strict=True, reason=GSPMD_ATTENTION_2X2)]
                           if (a, k, m) in XFAIL else [])
              for a in FLOP_ARCHS for k in SHAPES for m in FLOP_MESHES]


@pytest.mark.parametrize("arch,kind,mesh_shape", FLOP_CASES)
def test_dot_flops_a_shard_match_the_reference_hlo(reference_flops, arch, kind, mesh_shape):
    ref = reference_flops[f"{arch}|{kind}|{mesh_shape[0]}x{mesh_shape[1]}"]
    got = _port_flops(arch, kind, mesh_shape)
    want = ref - _readout_flops(arch, kind, mesh_shape[0]) / mesh_shape[1]
    assert ref > 0
    assert abs(got - want) <= DOT_RTOL * ref, (got, want, got / want)


def test_the_model_axis_divides_the_qwen3_train_step():
    """The re-anchor's numbers (B=4, T=64): 6.04e8 dot FLOPs a shard on
    1x1, 3.02e8 on 1x2, 1.51e8 on 1x4 and 2x2."""
    counts = {m: _port_flops("qwen3-8b", "train", m) for m in ((1, 1), (1, 2), (1, 4), (2, 2))}
    assert counts[(1, 1)] == pytest.approx(6.04e8, rel=1e-3)
    assert counts[(1, 2)] == counts[(1, 1)] / 2
    assert counts[(1, 4)] == counts[(2, 2)] == counts[(1, 1)] / 4


# ------------------------------------------------------------ gloo ranks
B, T = 4, 16
# name -> (reduced arch, mesh, world)
VALUE_CASES = {"qwen3_1x4": ("qwen3-8b", (1, 4), 4),
               "deepseek_v2_1x2": ("deepseek-v2-236b", (1, 2), 2),
               "llama_vision_1x2": ("llama-3.2-vision-90b", (1, 2), 2),
               "falcon_1x2": ("falcon-mamba-7b", (1, 2), 2)}
SERVE = ["--batch", "4", "--prompt-len", "3", "--gen", "3", "--device", "cpu"]


def _cfg(arch: str):
    return dataclasses.replace(tconfigs.get_reduced_config(arch), dtype="float32")


def _batch(cfg) -> dict:
    rng = np.random.default_rng(11)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))),
           "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))}
    if cfg.n_img_tokens:
        out["image_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    return out


def _step(arch: str, mesh_shape=None) -> tuple:
    """One float32 step's loss and every gradient (whole), from ``Model.init``
    at seed 0: on ``mesh_shape`` in this rank, else on one device."""
    from repro_torch.launch.mesh import P, gather_tree, make_debug_mesh
    from repro_torch.launch.mesh import shard as place
    from repro_torch.launch.mesh import shard_tree as place_tree
    from repro_torch.train.pytree import tree_leaves
    from repro_torch.train.step import _all_reduce, _value_and_grad, make_loss_fn

    cfg = _cfg(arch)
    mesh = make_debug_mesh(*mesh_shape) if mesh_shape else None
    model = Model(cfg, "cpu", mesh=mesh)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    if mesh is not None:
        params = place_tree(params, model.param_specs(), mesh)
        batch = {k: place(v, P(("data",), *([None] * (v.dim() - 1))), mesh)
                 for k, v in batch.items()}
    loss, _, grads = _value_and_grad(make_loss_fn(model), params, batch)
    if mesh is not None:
        grads = gather_tree(grads)
        loss = _all_reduce(loss, *model.batch_split(batch))
    return float(loss), [g.detach() for g in tree_leaves(grads)]


def _rank(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    try:
        res = {}
        for name, (arch, mesh_shape, w) in VALUE_CASES.items():
            if w != world:
                continue
            res[f"step_{name}"] = _step(arch, mesh_shape)
            gen, _ = serve_mod.run(serve_mod._parser().parse_args(
                ["--arch", f"reduced:{arch}", *SERVE, "--mesh", f"{mesh_shape[0]}x{mesh_shape[1]}"]))
            res[f"serve_{name}"] = gen.tolist()
        torch.save(res, os.path.join(out_dir, f"world{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' runs (two spawns, one at a time) and the one-device runs."""
    out = tmp_path_factory.mktemp("tensor_parallel")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for world in (4, 2):
            torch.multiprocessing.start_processes(
                _rank, args=(world, (out / f"store{world}").as_uri(), str(out)), nprocs=world,
                join=True, start_method="spawn")
        base = {}
        for name, (arch, _, _) in VALUE_CASES.items():
            base[f"step_{name}"] = _step(arch)
            gen, _ = serve_mod.run(serve_mod._parser().parse_args(
                ["--arch", f"reduced:{arch}", *SERVE]))
            base[f"serve_{name}"] = gen.tolist()
    finally:
        torch.set_num_threads(threads)
    got = {world: [torch.load(out / f"world{world}_rank{r}.pt") for r in range(world)]
           for world in (4, 2)}
    return got, base


@pytest.mark.parametrize("name", list(VALUE_CASES))
def test_loss_and_gradients_equal_one_device(ranks, name):
    got, base = ranks
    world = VALUE_CASES[name][2]
    want_loss, want = base[f"step_{name}"]
    whole = float(torch.cat([w.double().flatten() for w in want]).norm())
    for r, res in enumerate(got[world]):
        loss, grads = res[f"step_{name}"]
        assert loss == pytest.approx(want_loss, rel=RTOL), (name, r)
        assert len(grads) == len(want)
        diff = torch.cat([(g.double() - w.double()).flatten() for g, w in zip(grads, want)])
        assert float(diff.norm()) <= RTOL * whole, (name, r)
        for i, (g, w) in enumerate(zip(grads, want)):
            assert g.shape == w.shape
            assert float((g.double() - w.double()).norm()) <= RTOL * whole, (name, r, i)


@pytest.mark.parametrize("name", list(VALUE_CASES))
def test_greedy_tokens_equal_one_device(ranks, name):
    got, base = ranks
    world = VALUE_CASES[name][2]
    for res in got[world]:
        assert res[f"serve_{name}"] == base[f"serve_{name}"], name
