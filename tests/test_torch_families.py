"""The port's slice-14 families against the reference on the CPU: reduced
gemma3-12b (five sliding-window layers to one global, qk-norm, scaled and
tied embeddings: the ring cache), hubert-xlarge (encoder-only: frame
inputs, bidirectional attention, no ``embed``) and llama-3.2-vision-90b
(a gated cross-attention layer every fifth, over image embeddings).

Both packages compute with the same weights: the reference's
``Model.init(jax.random.key(0))``, carried over by
``repro_torch.convert.lm_params_from_arrays``; tokens, frames and image
embeddings are numpy-seeded. llama's gates are set to non-zero values (the
reference's init gives tanh(0) = 0, which would hide the image path), and
its image caches are filled as the reference's own test fills them
(``img @ wk``, ``img @ wv``: ``tests/test_models_smoke.py``).

float32 configs are held within 1e-4 (sums in another order): the forward
logits, every step of the prefill through decode steps (gemma3's 16-slot
rings wrap twice in 40 tokens; the kernel sums a ring's slots in slot
order, the reference in slot order too, both unlike position order), the
loss and every gradient leaf of one forward plus token cross-entropy (leaf
by leaf in JAX's order); greedy tokens and checkpoint leaves ``==``. One
bf16 forward per family is held at 0.1 absolute, as
``tests/test_torch_models.py`` holds the other families.
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
from repro.train import checkpoint as ref_ckpt
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.step import make_loss_fn as ref_make_loss_fn
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_arrays, lm_params_to_reference
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import prefill_into_cache
from repro_torch.models import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.train.step import make_loss_fn

FAMILIES = ["gemma3-12b", "hubert-xlarge", "llama-3.2-vision-90b"]
DECODERS = ["gemma3-12b", "llama-3.2-vision-90b"]  # hubert has no decode path
TOL = 1e-4
GATES = (0.7, -0.4)  # llama's cross layers, one a block (the reduced config has two)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _with_gates(jcfg, jparams):
    """The reference's parameters with each cross layer's gate set to GATES."""
    blocks = list(jparams["blocks"])
    for j, spec in enumerate(jcfg.block):
        if spec.mixer == "cross_attn":
            gate = blocks[j]["attn"]["gate"]
            values = jnp.asarray(GATES[: gate.shape[0]], gate.dtype).reshape(gate.shape)
            blocks[j] = dict(blocks[j], attn=dict(blocks[j]["attn"], gate=values))
    return dict(jparams, blocks=tuple(blocks))


def _models(arch: str, dtype: str = "float32"):
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(arch), dtype=dtype)
    mesh = _mesh()
    jmodel = JaxModel(jcfg, Axes(dp=("data",), tp="model"), mesh)
    with use_mesh(mesh):
        jparams = _with_gates(jcfg, jmodel.init(jax.random.key(0)))
    tmodel = Model(tcfg, "cpu")
    tparams = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tmodel, tparams, mesh


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return _models(request.param)


def _inputs(cfg, batch: int, seq: int, seed: int) -> dict:
    """numpy inputs: tokens or frames, image embeddings for a vision model,
    and next-token labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "frames":
        out["frames"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq))
    if cfg.n_img_tokens:
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq))
    return out


def _jax(inputs: dict) -> dict:
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
            for k, v in inputs.items()}


def _torch(inputs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _np(t):
    return np.asarray(t, np.float32)


# ------------------------------------------------------------------ forward
def test_forward_logits_match(family):
    jmodel, jparams, tmodel, tparams, mesh = family
    inputs = _inputs(tmodel.cfg, 2, 24, seed=1)
    with use_mesh(mesh):
        want, jaux = jmodel.forward(jparams, _jax(inputs))
    got, aux = tmodel.forward(tparams, _torch(inputs))
    assert got.shape == (2, 24, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    assert float(aux) == float(jaux) == 0.0


def test_cross_layers_without_images_attend_to_their_input():
    """Without ``image_embeds`` a cross-attention layer is self-attention
    (RoPE, causal, no gate) in the reference; the port does the same."""
    jmodel, jparams, tmodel, tparams, mesh = _models("llama-3.2-vision-90b")
    inputs = _inputs(tmodel.cfg, 2, 16, seed=2)
    del inputs["image_embeds"]
    with use_mesh(mesh):
        want, _ = jmodel.forward(jparams, _jax(inputs))
    got, _ = tmodel.forward(tparams, _torch(inputs))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


# ------------------------------------------------------- prefill and decode
def _fill_images(jmodel, jparams, jcache, tmodel, tparams, tcache, img: np.ndarray):
    """Both packages' image caches from the same embeddings, as the
    reference's ``tests/test_models_smoke.py`` fills them."""
    cfg = jmodel.cfg
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    blocks = list(jcache["blocks"])
    for j, spec in enumerate(cfg.block):
        if spec.mixer != "cross_attn":
            continue
        p = jparams["blocks"][j]["attn"]
        k = jnp.einsum("bnd,ldf->lbnf", jnp.asarray(img), p["wk"])
        v = jnp.einsum("bnd,ldf->lbnf", jnp.asarray(img), p["wv"])
        shape = k.shape[:3] + (hkv, dh)
        blocks[j] = dict(blocks[j], k_img=k.reshape(shape).astype(blocks[j]["k_img"].dtype),
                         v_img=v.reshape(shape).astype(blocks[j]["v_img"].dtype))
    x = torch.from_numpy(img)
    b, n = img.shape[:2]
    for spec, p, c in zip(tmodel.cfg.layers(), tparams["layers"], tcache):
        if spec.mixer == "cross_attn":
            c["k_img"].copy_((x @ p["attn"]["wk"]).reshape(b, n, hkv, dh))
            c["v_img"].copy_((x @ p["attn"]["wv"]).reshape(b, n, hkv, dh))
    return dict(jcache, blocks=tuple(blocks)), tcache


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_through_decode_steps_match_and_greedy_tokens_equal(arch):
    """40 tokens through decode steps into a 48-long cache (gemma3's local
    layers: 16-slot rings that wrap at positions 16 and 32), every step's
    logits held against the reference's step, the last against the
    reference's ``prefill_into_cache``; then 8 greedy tokens each, equal."""
    jmodel, jparams, tmodel, tparams, mesh = _models(arch)
    cfg = tmodel.cfg
    b, plen, seq = 2, 40, 48
    inputs = _inputs(cfg, b, plen, seed=3)
    toks = inputs["tokens"]
    jcache, tcache = jmodel.init_cache(b, seq), tmodel.init_cache(b, seq)
    if cfg.n_img_tokens:
        jcache, tcache = _fill_images(jmodel, jparams, jcache, tmodel, tparams, tcache,
                                      inputs["image_embeds"])
    if arch == "gemma3-12b":
        windows = [s.window for s in cfg.layers()]
        assert [c["k"].shape[1] for c in tcache] == [16 if w else seq for w in windows]
    start = jcache
    with use_mesh(mesh):
        step = jax.jit(jmodel.decode_step)
        for pos in range(plen):
            want, jcache = step(jparams, jcache, jnp.asarray(toks[:, pos : pos + 1], jnp.int32),
                                jnp.int32(pos))
            got, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, pos:pos + 1]),
                                             pos)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL,
                                       err_msg=f"step {pos}")
        last, _ = jax_prefill_into_cache(jmodel, jparams, start, jnp.asarray(toks, jnp.int32))
        np.testing.assert_allclose(got.numpy(), _np(last), rtol=TOL, atol=TOL)
        jtok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
        ttok = got[:, -1].argmax(-1)[:, None]
        jout, tout = [jtok], [ttok]
        for i in range(seq - plen - 1):
            want, jcache = step(jparams, jcache, jtok, jnp.int32(plen + i))
            got, tcache = tmodel.decode_step(tparams, tcache, ttok, plen + i)
            jtok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
            ttok = got[:, -1].argmax(-1)[:, None]
            jout.append(jtok)
            tout.append(ttok)
    np.testing.assert_array_equal(torch.cat(tout, 1).numpy(), np.concatenate(jout, 1))


def test_port_prefill_into_cache_equals_its_steps():
    """``launch.serve.prefill_into_cache`` is the decode steps of the test
    above; over a wrapping ring it ends on the same logits and cache."""
    _, _, tmodel, tparams, _ = _models("gemma3-12b")
    toks = torch.from_numpy(_inputs(tmodel.cfg, 2, 40, seed=3)["tokens"])
    logits, cache = prefill_into_cache(tmodel, tparams, tmodel.init_cache(2, 48), toks)
    again = tmodel.init_cache(2, 48)
    for pos in range(40):
        step, again = tmodel.decode_step(tparams, again, toks[:, pos : pos + 1], pos)
    assert torch.equal(logits, step)
    for a, b in zip(cache, again):
        assert all(torch.equal(a[n], b[n]) for n in a)


# ------------------------------------------------------ loss and gradients
def test_loss_and_every_gradient_leaf_match(family):
    jmodel, jparams, tmodel, tparams, mesh = family
    inputs = _inputs(tmodel.cfg, 2, 16, seed=4)
    with use_mesh(mesh):
        (jloss, jmetrics), jgrads = jax.value_and_grad(ref_make_loss_fn(jmodel), has_aux=True)(
            jparams, _jax(inputs))
    leaves, treedef = tree_flatten(tparams)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = make_loss_fn(tmodel)(tree_unflatten(treedef, leaves), _torch(inputs))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]), rtol=TOL)
    port = tree_leaves(lm_params_to_reference(tmodel.cfg, tree_unflatten(treedef, grads)))
    ref = jax.tree.leaves(jgrads)
    assert len(port) == len(ref)
    for got, want in zip(port, ref):
        want = _np(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * max(
            1.0, float(np.abs(want).max())))
    if tmodel.cfg.n_img_tokens:  # the gates carry a gradient
        gates = [g for g, k in zip(grads, _leaf_names(tparams)) if k.endswith("gate")]
        assert gates and all(float(g.abs().max()) > 0 for g in gates)


def _leaf_names(tree, prefix=""):
    """The leaves' paths, in the order of ``tree_leaves``."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", FAMILIES)
def test_checkpoint_leaves_cross_both_ways(tmp_path, arch):
    """A bf16 model's state saved by the reference restores in the port
    leaf for leaf, and the port's save restores in the reference: hubert's
    tree without ``embed``, llama's with each cross layer's ``gate``."""
    jmodel, jp, tmodel, _, mesh = _models(arch, "bfloat16")
    tcfg = tmodel.cfg
    state_dtype = jnp.dtype(tcfg.opt_state_dtype)
    jo = dataclasses.replace(
        ref_adamw_init(jp, state_dtype), step=jnp.int32(5),
        m=jax.tree.map(lambda a: (a * 0.5).astype(state_dtype), jp),
        v=jax.tree.map(lambda a: (a * a).astype(state_dtype), jp))
    assert ("embed" in jp) == (tcfg.frontend != "frames")
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, (jp, jo))
    p0 = tmodel.init(torch.Generator().manual_seed(0))
    assert p0.keys() == lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp), "cpu").keys()
    params, opt, step = train_mod.restore(str(tmp_path / "ref"), tcfg, p0,
                                          adamw_init(p0, tcfg.opt_state_dtype), "cpu")
    assert step == 5 and int(opt.step) == 5
    ref_leaves = jax.tree.leaves((jp, jo))
    port_tree = train_mod.checkpoint_tree(tcfg, params, opt)
    assert len(tree_leaves(port_tree)) == len(ref_leaves)
    for got, want in zip(tree_leaves(port_tree), ref_leaves):
        assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    names = _leaf_names(params)
    assert any(n.endswith("/gate") for n in names) == bool(tcfg.n_img_tokens)
    ckpt.save_checkpoint(str(tmp_path / "port"), 6, port_tree)
    (rp, ro), rstep = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), (jp, jo))
    assert rstep == 6
    for got, want in zip(jax.tree.leaves((rp, ro)), ref_leaves):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(_np(got), _np(want))


# -------------------------------------------------------------------- bf16
@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_forward_close(arch):
    jmodel, jparams, tmodel, tparams, mesh = _models(arch, "bfloat16")
    inputs = _inputs(tmodel.cfg, 2, 16, seed=5)
    with use_mesh(mesh):
        want, _ = jmodel.forward(jparams, _jax(inputs))
    got, _ = tmodel.forward(tparams, _torch(inputs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0, atol=0.1)


# ------------------------------------------------------------ entry points
def test_hubert_has_no_decode_path():
    cfg = tconfigs.get_reduced_config("hubert-xlarge")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert "embed" not in params and "unembed" in params
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(params, model.init_cache(1, 4), torch.zeros(1, 1, dtype=torch.long), 0)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_main(["--arch", "reduced:hubert-xlarge", "--device", "cpu"])


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_launcher_on_cpu(arch, capsys):
    """The launcher's loop (zero image caches for llama, as the reference's
    serve runs it) past gemma3's window."""
    gen = serve_main(["--arch", f"reduced:{arch}", "--batch", "2", "--prompt-len", "14",
                      "--gen", "6", "--device", "cpu"])
    assert gen.shape == (2, 6)
    assert "generated token ids" in capsys.readouterr().out
