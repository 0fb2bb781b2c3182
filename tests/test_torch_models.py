"""The port's LM serving slice against the reference on the CPU: reduced
qwen3-8b (GQA, qk-norm; the flash-attention path), falcon-mamba-7b
(Mamba-1; the selective-scan path), the dense minitron-8b (squared ReLU)
and deepseek-coder-33b (g = 7 query heads a KV head at full width), and the
MoE families jamba-v0.1-52b (Mamba, attention and the MoE in one stack) and
arctic-480b (a dense FFN beside the MoE in every layer); since slice 14
also gemma3-12b and llama-3.2-vision-90b through the same fixtures (hubert-
xlarge, encoder-only, only in the config checks: its frame inputs,
gradients and checkpoints are ``tests/test_torch_families.py``'s, with the
other two families' ring cache, image caches and gates); since slice 15
also deepseek-v2-236b (MLA and a dense prefix layer before the MoE blocks;
its attention paths, gradients and checkpoints are
``tests/test_torch_mla.py``'s).

Both packages compute with the same weights: the reference's
``Model.init(jax.random.key(0))``, carried over by
``repro_torch.convert.lm_params_from_arrays``; inputs are numpy-seeded.
Comparisons run in float32 configs, where the tolerance is 1e-4 for the
logits and the router aux loss (float32 sums in another order; the scan's
and attention's own tolerances are their kernels' tests) and greedy tokens
must be equal. One bf16 case per model is held at 0.1 absolute on logits
of magnitude about 1-4: bf16 rounds at other places in XLA-CPU and
torch-CPU, and a rounding differs by one bf16 ulp (2^-8 relative) and
grows through the layers. In jamba-v0.1-52b that
one-ulp difference (its Mamba mixers round at other places) flips a
token's expert choice at its fourth layer (0.55 at that layer's output,
up to 3.5 at the logits), so its bf16 case is held layer by layer instead:
each sublayer (mixer, then FFN) from the reference's input, within 0.1, with
equal routing where the inputs are equal; arctic-480b is held both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.configs as jconfigs
from repro.compat import use_mesh
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache
from repro.models import Axes
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models.model import apply_layer as jax_apply_layer
from repro.train.step import make_prefill_step as jax_make_prefill_step
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import LayerSpec, Model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.serve.lm import make_decode_step, make_prefill_step

ARCHS = ["qwen3-8b", "falcon-mamba-7b", "minitron-8b", "deepseek-coder-33b", "jamba-v0.1-52b",
         "arctic-480b", "gemma3-12b", "llama-3.2-vision-90b", "hubert-xlarge",
         "deepseek-v2-236b"]
DECODE_ARCHS = [a for a in ARCHS if a != "hubert-xlarge"]  # token inputs, a decode path
MOE_ARCHS = ("jamba-v0.1-52b", "arctic-480b")
TOL = 1e-4


def tiny_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _cfgs(arch: str, dtype: str = "float32"):
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(arch), dtype=dtype)
    return jcfg, tcfg


def _models(arch: str, dtype: str = "float32"):
    jcfg, tcfg = _cfgs(arch, dtype)
    mesh = tiny_mesh()
    jmodel = JaxModel(jcfg, Axes(dp=("data",), tp="model"), mesh)
    jparams = jmodel.init(jax.random.key(0))
    tmodel = Model(tcfg, "cpu")
    tparams = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tmodel, tparams, mesh


@pytest.fixture(scope="module", params=DECODE_ARCHS)
def pair(request):
    return _models(request.param)


def _np(t):
    return np.asarray(t, np.float32)


def _tokens(cfg, batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))


# ------------------------------------------------------------------ configs
def _plain(value):
    """Layer specs of either package as tuples, other fields as they are."""
    if isinstance(value, tuple):
        return tuple(dataclasses.astuple(s) for s in value)
    return value


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for jget, tget in ((jconfigs.get_config, tconfigs.get_config),
                       (jconfigs.get_reduced_config, tconfigs.get_reduced_config)):
        jcfg, tcfg = jget(arch), tget(arch)
        for f in dataclasses.fields(tcfg):
            assert _plain(getattr(tcfg, f.name)) == _plain(getattr(jcfg, f.name)), f.name
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        assert tcfg.num_layers == jcfg.num_layers and tcfg.head_dim == jcfg.head_dim
    assert tconfigs.get_model_config(f"reduced:{arch}") == tconfigs.get_reduced_config(arch)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b"])
def test_other_architectures_name_their_roadmap_item(arch):
    """Every architecture of the reference now runs in the port: the last
    one waiting (deepseek-v2-236b) is a config like the others, nothing is
    left in ``LATER``, and a name the reference does not have still raises."""
    assert tconfigs.LATER == {}
    assert sorted(tconfigs.ALIASES) == sorted(jconfigs.ALIASES)
    cfg = tconfigs.get_config(arch)
    assert cfg.use_mla and cfg.prefix and cfg == tconfigs.get_model_config(arch)
    with pytest.raises(ValueError, match="unknown architecture"):
        tconfigs.get_config("no-such-model")


def test_unported_layers_raise():
    """MLA and prefix layers, which raised before slice 15, now build and
    run on any base: reduced qwen3-8b with MLA in its blocks, and with an
    MoE prefix layer, each through a forward and a decode step; and the
    sliding-window ring cache's slots."""
    base = dataclasses.replace(tconfigs.get_reduced_config("qwen3-8b"), dtype="float32")
    mla = dict(use_mla=True, kv_lora_rank=32, q_lora_rank=None, qk_rope_dim=16, qk_nope_dim=32,
               v_head_dim=32)
    for change in (mla, dict(prefix=(LayerSpec("attn", "moe"),), n_experts=4, top_k=2)):
        model = Model(dataclasses.replace(base, **change), "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        toks = torch.tensor([[3, 5, 7]])
        logits, _ = model.forward(params, {"tokens": toks})
        step, _ = model.decode_step(params, model.init_cache(1, 4), toks[:, :1], 0)
        assert logits.shape == (1, 3, 512) and bool(step.isfinite().all())
        assert len(params["layers"]) == model.cfg.num_layers
        if "use_mla" in change:
            assert "wq" in params["layers"][0]["attn"]  # no q_lora_rank: one query projection
    windowed = dataclasses.replace(base, block=(LayerSpec("attn", "dense", window=8),
                                                LayerSpec("attn", "dense")))
    # the sliding-window ring cache: a window-long ring, the reference's slots
    model = Model(windowed, "cpu")
    assert [c["k"].shape[1] for c in model.init_cache(1, 16)] == [8, 16] * 2
    assert [c["k"].shape[1] for c in model.init_cache(1, 5)] == [5, 5] * 2
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(1, 16)
    for pos in range(11):
        before = [c["k"].clone() for c in cache[:2]]
        model.decode_step(params, cache, torch.tensor([[pos + 3]]), pos)
        changed = [(c["k"] != b)[0].flatten(1).any(-1) for c, b in zip(cache, before)]
        assert changed[0].nonzero().flatten().tolist() == [pos % 8]  # the ring's slot
        assert changed[1].nonzero().flatten().tolist() == [pos]


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_norms_and_rope_match(dtype, tol):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5))
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    js, ts = jnp.asarray(scale, dtype), torch.from_numpy(scale).to(getattr(torch, dtype))
    pairs = [
        (jlayers.rms_norm(jx, {"scale": js}), tlayers.rms_norm(tx, {"scale": ts})),
        (jlayers.qk_head_norm(jx, js), tlayers.qk_head_norm(tx, ts)),
        (jlayers.apply_rope(jx, jnp.asarray(pos), 1e6),
         tlayers.apply_rope(tx, torch.from_numpy(pos), 1e6)),
        (jlayers.rope_freqs(32, 1e4), tlayers.rope_freqs(32, 1e4)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "sq_relu"])
def test_dense_ffn_matches(activation):
    rng = np.random.default_rng(2)
    arrays = {"w_in": rng.standard_normal((16, 24)), "w_out": rng.standard_normal((24, 16)),
              "w_gate": rng.standard_normal((16, 24))}
    x = rng.standard_normal((3, 16)).astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrays.items()}
    want = jlayers.dense_ffn(jnp.asarray(x), jp, activation)
    got = tlayers.dense_ffn(torch.from_numpy(x), tp, activation)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_gqa_forward_matches():
    jmodel, jparams, tmodel, tparams, mesh = _models("qwen3-8b")
    x = np.random.default_rng(3).standard_normal((2, 24, 128)).astype(np.float32) * 0.5
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["attn"])
    with use_mesh(mesh):
        want, (jk, jv) = jattn.gqa_forward(jnp.asarray(x), jp, jmodel.cfg, window=None)
    got, (k, v) = tattn.gqa_forward(torch.from_numpy(x), tparams["layers"][0]["attn"],
                                    tmodel.cfg, window=None)
    for w, g in ((want, got), (jk, k), (jv, v)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=TOL, atol=TOL)



@pytest.mark.parametrize("window", [None, 300])
def test_gqa_flash_decode_matches_the_reference_at_a_long_cache(window):
    """One decode step's attention over a 4,096-long cache (where the card's
    kernel splits the cache): the port's ``gqa_flash_decode`` against the
    reference's sharded one on the 1 x 1 mesh, reduced qwen3-8b heads."""
    jmodel, _, tmodel, _, mesh = _models("qwen3-8b")
    cfg = tmodel.cfg
    rng = np.random.default_rng(4096 + (window or 0))
    b, s, pos = 2, 4096, 4000
    q = rng.standard_normal((b, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
            for _ in range(2))
    with use_mesh(mesh):
        want = jattn.gqa_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.int32(pos), window, jmodel.ax, mesh)
    got = tattn.gqa_flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 pos, window)
    assert got.shape == (b, cfg.n_heads, cfg.head_dim)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)

def test_mamba_forward_and_decode_step_match():
    jmodel, jparams, tmodel, tparams, mesh = _models("falcon-mamba-7b")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 128)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mamba"])
    tp = tparams["layers"][0]["mamba"]
    want, (jconv, jssm) = jmamba.mamba_forward(jnp.asarray(x), jp, jmodel.cfg)
    got, (conv, ssm) = tmamba.mamba_forward(torch.from_numpy(x), tp, tmodel.cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(conv.numpy(), _np(jconv), rtol=TOL, atol=TOL)
    assert not ssm.any() and not np.asarray(jssm).any()  # the reference's zero state
    state = rng.standard_normal((2, 256, 16)).astype(np.float32) * 0.1
    want, (jconv2, jssm2) = jmamba.mamba_decode_step(jnp.asarray(x[:, :1]), jp, jmodel.cfg,
                                                     jconv, jnp.asarray(state))
    got, (conv2, ssm2) = tmamba.mamba_decode_step(torch.from_numpy(x[:, :1]), tp, tmodel.cfg,
                                                  conv, torch.from_numpy(state))
    for w, g in ((want, got), (jconv2, conv2), (jssm2, ssm2)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=TOL, atol=TOL)


# -------------------------------------------------------------------- model
def test_init_matches_reference_layout(pair):
    """The port's own ``init`` gives the same structure, shapes and dtypes
    as the reference's parameters carried over."""
    _, _, tmodel, tparams, _ = pair
    own = tmodel.init(torch.Generator().manual_seed(0))
    flat_own = {k: v for k, v in _flatten(own)}
    flat_ref = {k: v for k, v in _flatten(tparams)}
    assert flat_own.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        assert flat_own[k].shape == v.shape and flat_own[k].dtype == v.dtype, k
    for k in flat_ref:  # the constants of the reference's init, to the ulp of a log
        if k.endswith(("a_log", "d_skip", "scale", "conv_b", "dt_bias")):
            torch.testing.assert_close(flat_own[k], flat_ref[k], rtol=2e-7, atol=0)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_prefill_step_logits_match(pair):
    jmodel, jparams, tmodel, tparams, mesh = pair
    toks = _tokens(tmodel.cfg, 2, 16)
    with use_mesh(mesh):
        want = jax_make_prefill_step(jmodel)(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = make_prefill_step(tmodel)(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    full, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    with use_mesh(mesh):
        jfull, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    np.testing.assert_allclose(full.numpy(), _np(jfull), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=1e-12)
    assert (float(aux) > 0) == (tmodel.cfg.n_experts > 0)  # the summed router loss


def test_decode_steps_from_empty_cache_match(pair):
    jmodel, jparams, tmodel, tparams, mesh = pair
    toks = _tokens(tmodel.cfg, 2, 5, seed=1)
    jcache = jmodel.init_cache(2, 8)
    tcache = tmodel.init_cache(2, 8)
    decode = make_decode_step(tmodel)
    for pos in range(toks.shape[1]):
        with use_mesh(mesh):
            want, jcache = jmodel.decode_step(
                jparams, jcache, jnp.asarray(toks[:, pos : pos + 1], jnp.int32), jnp.int32(pos))
        got, tcache = decode(tparams, tcache, torch.from_numpy(toks[:, pos : pos + 1]), pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    # the decode path's last logits equal the full forward's at that position;
    # not with MoE layers, whose capacity (so which pairs drop) depends on
    # the tokens of a call: 2 a decode step, 10 in the forward
    # not with cross-attention layers either: without images the forward's
    # attend to their input, the decode step's to the (zero) image caches
    if tmodel.cfg.n_experts == 0 and not tmodel.cfg.n_img_tokens:
        full, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(), rtol=TOL, atol=TOL)


def _reference_serve(jmodel, jparams, mesh, prompts, gen):
    """The reference launcher's loop (``repro.launch.serve.main``) without its
    jit: prefill through decode steps, then greedy argmax."""
    b, plen = prompts.shape
    with use_mesh(mesh):
        cache = jmodel.init_cache(b, plen + gen)
        logits, cache = jax_prefill_into_cache(jmodel, jparams, cache,
                                               jnp.asarray(prompts, jnp.int32))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        out = [tok]
        for i in range(gen - 1):
            logits, cache = jmodel.decode_step(jparams, cache, tok, jnp.int32(plen + i))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1)


def test_serve_greedy_tokens_equal_the_reference(pair):
    jmodel, jparams, tmodel, tparams, mesh = pair
    prompts = np.random.default_rng(0).integers(2, tmodel.cfg.vocab_size, (2, 6))
    want = _reference_serve(jmodel, jparams, mesh, prompts, 5)
    got, timings = serve(tmodel, tparams, torch.from_numpy(prompts), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert timings["prefill_s"] > 0 and timings["decode_tok_per_s"] > 0


@pytest.mark.parametrize("arch", [a for a in DECODE_ARCHS if a != "jamba-v0.1-52b"])
def test_bf16_prefill_close(arch):
    jmodel, jparams, tmodel, tparams, mesh = _models(arch, "bfloat16")
    assert tparams["embed"].dtype == torch.bfloat16
    toks = _tokens(tmodel.cfg, 2, 16, seed=2)
    with use_mesh(mesh):
        want = jax_make_prefill_step(jmodel)(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = make_prefill_step(tmodel)(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0, atol=0.1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_moe_stack_close_layer_by_layer(arch):
    """Every layer of the bf16 stack from the reference's input: the
    mixer's residual, then the FFN's (dense, MoE or both) from the
    reference's mid-layer state, each within 0.1 absolute, and each MoE
    layer's router loss within 1e-3 (equal routing)."""
    jmodel, jparams, tmodel, tparams, mesh = _models(arch, "bfloat16")
    cfg, width = jmodel.cfg, len(jmodel.cfg.block)
    toks = _tokens(cfg, 2, 16, seed=2)
    x = jparams["embed"][jnp.asarray(toks, jnp.int32)]
    jitted = {}  # one reference function per sublayer kind

    def sublayer(s: LayerSpec):
        if s not in jitted:
            jitted[s] = jax.jit(lambda x, p: jax_apply_layer(x, p, s, cfg, jmodel.ax, mesh)[:2])
        return jitted[s]

    with use_mesh(mesh):
        for i, spec in enumerate(cfg.layers()):
            p = jax.tree.map(lambda a, b=i // width: a[b], jparams["blocks"][i % width])
            tp = tparams["layers"][i]
            parts = (sublayer(LayerSpec(spec.mixer, "none")), sublayer(LayerSpec("none", spec.ffn)))
            for j, part in enumerate(parts):
                want, jaux = part(x, p)
                tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                if j == 0:
                    got, _ = tmodel._layer(tx, tp, LayerSpec(spec.mixer, "none"))
                else:
                    got, taux = tmodel._ffn(tx, tp, spec)
                    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-3)
                assert got.dtype == torch.bfloat16
                np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0, atol=0.1,
                                           err_msg=f"layer {i} {spec} part {j}")
                x = want


def test_serve_launcher_on_cpu(capsys):
    gen = serve_main(["--arch", "reduced:falcon-mamba-7b", "--batch", "2", "--prompt-len", "4",
                      "--gen", "3", "--device", "cpu"])
    assert gen.shape == (2, 3)
    assert "generated token ids" in capsys.readouterr().out
