"""deepseek-v2-236b's parts of the port against the reference on the CPU:
the attention kernel's plain version where the value is narrower than the
query and key (MLA's (Dqk, Dv) pairs), ``mla_forward`` (the expanded form,
prefill), ``mla_flash_decode`` (the absorbed form over the latent cache),
the reduced config end to end (forward, decode steps, the loss and every
gradient leaf, greedy tokens) and its dense prefix layer's way through
``convert`` (parameters, AdamW moments and checkpoints in JAX's leaf order).

Both packages compute with the same weights: the reference's
``Model.init(jax.random.key(0))``, carried over by
``repro_torch.convert.lm_params_from_arrays``; inputs are numpy-seeded.
Tolerances: the attention's are ``tests/test_kernels.py``'s (2e-5 in
float32, sums in another order; 2e-2 in bf16, one rounding of the output);
the model's float32 outputs 1e-4 (the other families' tolerance: float32
sums in another order through the layers); gradients 1e-4 of each leaf's
largest entry; greedy tokens and checkpoint leaves ``==``. The reference's
decode runs ``mla_flash_decode`` as a shard_map on its tiny 1 x 1 mesh (one
stripe), as its own tests run it.
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
from repro.models import Axes
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models.config import LayerSpec as JaxLayerSpec
from repro.train import checkpoint as ref_ckpt
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.step import make_loss_fn as ref_make_loss_fn
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_arrays, lm_params_to_reference
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import LayerSpec, Model
from repro_torch.models import attention as tattn
from repro_torch.serve import lm as tlm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.pytree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.train.step import make_loss_fn

ARCH = "deepseek-v2-236b"
TOL = 1e-4
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _models(dtype: str = "float32"):
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(ARCH), dtype=dtype)
    mesh = _mesh()
    jmodel = JaxModel(jcfg, Axes(dp=("data",), tp="model"), mesh)
    with use_mesh(mesh):
        jparams = jmodel.init(jax.random.key(0))
    tmodel = Model(tcfg, "cpu")
    tparams = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tmodel, tparams, mesh


@pytest.fixture(scope="module")
def pair():
    return _models()


@pytest.fixture(scope="module")
def jax_step(pair):
    """The reference's ``decode_step`` compiled once (as its serve launcher
    jits it), ``pos`` a traced int32."""
    jmodel, _, _, _, mesh = pair
    step = jax.jit(jmodel.decode_step)

    def call(params, cache, tokens, pos):
        with use_mesh(mesh):
            return step(params, cache, jnp.asarray(tokens, jnp.int32), jnp.int32(pos))

    return call


def _np(t):
    return np.asarray(t, np.float32)


def _tokens(cfg, batch, seq, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq))


# ---------------------------------------------------------- the configs
def test_configs_carry_mla_widths_and_the_prefix():
    """The full config and the reduced one (the reference's ``shrink`` MLA
    branch: r 32, q rank 48, rope 16, nope 32, v 32) field by field, and the
    kernel pairs they give: (192, 128) / (576, 512), and (48, 32) for both."""
    assert tconfigs.LATER == {}
    for jget, tget in ((jconfigs.get_config, tconfigs.get_config),
                       (jconfigs.get_reduced_config, tconfigs.get_reduced_config)):
        jcfg, tcfg = jget(ARCH), tget(ARCH)
        assert tcfg.param_count() == jcfg.param_count()
        for name in ("kv_lora_rank", "q_lora_rank", "qk_rope_dim", "qk_nope_dim", "v_head_dim",
                     "n_heads", "n_kv_heads", "n_experts", "top_k", "n_shared_experts"):
            assert getattr(tcfg, name) == getattr(jcfg, name), name
        assert [dataclasses.astuple(s) for s in tcfg.prefix] == \
            [dataclasses.astuple(s) for s in jcfg.prefix]
    full, small = tconfigs.get_config(ARCH), tconfigs.get_reduced_config(ARCH)
    for cfg, prefill, decode in ((full, (192, 128), (576, 512)), (small, (48, 32), (48, 32))):
        assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) == prefill
        assert (cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank) == decode
        assert prefill in ops.MLA_PAIRS and decode in ops.MLA_PAIRS
    assert full.param_count() == 235_741_312_000
    one_block = dataclasses.replace(full, n_blocks=1)  # what fits one card at full width
    assert 5.3e9 < one_block.param_count() < 5.4e9


# --------------------------------------------- the attention at MLA's pairs
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,dqk,dv,causal,window", [
    (2, 24, 4, 48, 32, True, None),     # the reduced config's prefill
    (1, 40, 4, 192, 128, True, None),   # deepseek-v2-236b's widths
    (1, 33, 2, 192, 128, False, None),
    (2, 30, 4, 48, 32, True, 8),
])
def test_plain_attention_at_mla_pairs_matches_model_sdpa(b, t, h, dqk, dv, causal, window,
                                                         dtype):
    """The plain version with Dv < Dqk against the reference's ``_sdpa``,
    which scales by the query's width and returns the value's, in the
    model's ``[B, T, H, D]`` layout (the port's transposed views)."""
    rng = np.random.default_rng(dqk + t)
    arrays = [rng.standard_normal((b, t, h, d)).astype(np.float32) for d in (dqk, dqk, dv)]
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)).transpose(1, 2) for a in arrays)
    want = jattn._sdpa(jq, jk, jv, causal, window)
    got = ops.flash_attention(q, k, v, causal=causal, window=window).transpose(1, 2)
    assert got.shape == (b, t, h, dv) and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])


def test_plain_attention_at_mla_pairs_matches_chunked_sdpa():
    """From 8,192 tokens the reference's MLA prefill runs ``_chunked_sdpa``;
    the port's one kernel covers it (here 2,048 tokens in two chunks)."""
    rng = np.random.default_rng(2048)
    arrays = [rng.standard_normal((1, 2048, 2, d)).astype(np.float32) for d in (48, 48, 32)]
    want = jattn._chunked_sdpa(*(jnp.asarray(a) for a in arrays), True, None)
    got = ops.flash_attention(*(torch.from_numpy(a).transpose(1, 2) for a in arrays))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tq,group,dqk,dv,aligned,variant", [
    (torch.bfloat16, 8192, 1, 192, 128, True, "wgmma_bf16"),  # deepseek-v2 prefill
    (torch.bfloat16, 17, 1, 192, 128, True, "wgmma_bf16"),
    (torch.bfloat16, 8192, 1, 192, 128, False, "fma"),       # unaligned rows
    (torch.float32, 8192, 1, 192, 128, True, "fma"),
    (torch.bfloat16, 16, 1, 192, 128, True, "decode_latent"),  # a short prompt
    (torch.bfloat16, 1, 128, 576, 512, True, "latent_wgmma"),  # the absorbed decode step
    (torch.bfloat16, 16, 8, 576, 512, True, "latent_wgmma"),   # 16 query rows a head
    (torch.bfloat16, 1, 128, 576, 512, False, "decode_latent"),  # unaligned
    (torch.float32, 1, 128, 576, 512, True, "decode_latent"),  # float32: the FMA kernel
    (torch.float32, 1, 128, 576, 512, False, "decode_latent"),
    (torch.bfloat16, 16, 1, 192, 128, False, "decode_latent"),
    (torch.float32, 16, 1, 192, 128, True, "decode_latent"),
    (torch.float32, 24, 1, 48, 32, True, "fma"),               # reduced prefill
    (torch.bfloat16, 24, 1, 48, 32, True, "fma"),              # no tensor-core build there
    (torch.float32, 1, 4, 48, 32, True, "decode_latent"),      # reduced decode step
    (torch.bfloat16, 1, 4, 48, 32, True, "decode_latent"),     # no latent_wgmma there
])
def test_kernel_variant_routes_mla_pairs(dtype, tq, group, dqk, dv, aligned, variant):
    assert ops.kernel_variant(dtype, tq, group, dqk, aligned, dv) == variant
    assert variant in ops.MLA_PAIRS[(dqk, dv)]
    assert ops.kernel_variant(dtype, tq, group, dqk, aligned, dqk) == \
        ops.kernel_variant(dtype, tq, group, dqk, aligned)


@pytest.mark.parametrize("dtype,aligned", [(torch.bfloat16, True), (torch.bfloat16, False),
                                           (torch.float32, True)])
def test_latent_wgmma_needs_the_value_in_the_key(dtype, aligned):
    """``latent_wgmma`` reads the value from the key's tile: a value that is
    not a view of the key's first columns routes to ``decode_latent``."""
    assert ops.kernel_variant(dtype, 1, 128, 576, aligned, 512, shared_value=False) == \
        "decode_latent"
    assert ops.kernel_variant(dtype, 1, 128, 576, aligned, 512, shared_value=True) == \
        ("latent_wgmma" if dtype == torch.bfloat16 and aligned else "decode_latent")


def test_value_in_key_reads_views():
    """``ops.value_in_key``: the model's latent views (the value the key's
    first 512 columns, in place) are; a copy, another buffer or an offset
    view are not."""
    buf = torch.zeros(2, 40, 576)
    k = buf[:, None]
    assert ops.value_in_key(k, k[..., :512])
    assert not ops.value_in_key(k, k[..., :512].clone())
    assert not ops.value_in_key(k, torch.zeros(2, 1, 40, 512))
    assert not ops.value_in_key(k, k[..., 64:])
    assert not ops.value_in_key(k, buf[:, None, 1:, :512])


def test_latent_decode_constants_match_the_kernel():
    """``ops.LATENT_ROWS`` / ``LATENT_COLS`` are the kernel's tile (what the
    split count's block count is read from), and the latent decode at full
    width runs 2 row tiles x 4 output slices a (batch, KV head)."""
    from pathlib import Path

    text = (Path(ops.__file__).parent / "csrc" / "flash_attention.cuh").read_text()
    assert f"constexpr int kLatBR = {ops.LATENT_ROWS};" in text
    assert f"constexpr int kLatDVS = {ops.LATENT_COLS};" in text
    assert ops.latent_blocks(128, 512) == 8 and ops.latent_blocks(4, 32) == 1
    assert ops.latent_blocks(16, 128) == 1
    # B = 8 over a 32k cache: 64 blocks, so 2 shares fill 132 SMs at one block an SM
    assert ops.decode_splits(8 * ops.latent_blocks(128, 512), 1, 32768, 132, 1) == 2
    assert ops.decode_splits(8 * ops.latent_blocks(128, 512), 1, 160, 132, 1) == 1


def test_latent_wgmma_constants_match_the_kernel():
    """``ops.LATENT_WGMMA_ROWS`` is the tensor-core kernel's row tile, its
    variant code is ``VARIANTS``' index, and a block holds all 512 output
    columns: 2 blocks a (batch, share) at 128 rows, so B = 8 over a 32k
    cache splits into 8 shares (128 blocks on 132 SMs) and over 160 keys
    into 1."""
    from pathlib import Path

    text = (Path(ops.__file__).parent / "csrc" / "flash_attention.cuh").read_text()
    assert f"constexpr int kLwBR = {ops.LATENT_WGMMA_ROWS};" in text
    assert f"kLatentWgmma = {ops.VARIANTS.index('latent_wgmma')}" in text
    assert "latent_wgmma" in ops.MLA_PAIRS[(576, 512)]
    assert ops.latent_blocks(128, 512, "latent_wgmma") == 2
    assert ops.latent_blocks(16, 512, "latent_wgmma") == 1
    assert ops.latent_blocks(129, 512, "latent_wgmma") == 3
    blocks = 8 * ops.latent_blocks(128, 512, "latent_wgmma")
    assert ops.decode_splits(blocks, 1, 32768, 132, 1) == 8
    assert ops.decode_splits(blocks, 1, 160, 132, 1) == 1


def _bf16_parts(p: torch.Tensor, parts: int) -> list:
    """``latent_wgmma``'s split of its float32 probabilities into bf16 wgmma
    operands: each part the residual rounded to bf16 (nearest even), the
    residual taken in float32."""
    out, rest = [], p.clone()
    for _ in range(parts):
        part = rest.bfloat16()
        out.append(part)
        rest = rest - part.float()
    return out


@pytest.mark.parametrize("parts,bits", [(1, 8), (2, 16), (3, 24)])
def test_latent_wgmma_splits_p_into_bf16_parts(parts, bits):
    """The kernel's P V takes P as ``kLwPParts`` bf16 operands: their sum
    keeps 8 bits of each probability a part, and three parts (the kernel's)
    give back every float32 probability to its last bit or so."""
    from pathlib import Path

    text = (Path(ops.__file__).parent / "csrc" / "flash_attention.cuh").read_text()
    assert "constexpr int kLwPParts = 3;" in text
    rng = np.random.default_rng(parts)
    p = torch.from_numpy(np.exp2(-rng.exponential(4.0, 100_000)).astype(np.float32))
    p[:4] = torch.tensor([1.0, 0.0, 0.5, 2.0**-30])
    total = sum(x.double() for x in _bf16_parts(p, parts))
    rel = ((total - p.double()).abs() / p.double().clamp_min(1e-300)).max().item()
    assert rel <= 2.0 ** -bits
    if parts == 3:
        assert rel <= 2.0 ** -23  # within float32's own rounding of the sum


# ------------------------------------------------------------------- layers
def test_mla_forward_matches_the_reference(pair):
    jmodel, jparams, tmodel, tparams, mesh = pair
    x = np.random.default_rng(3).standard_normal((2, 24, 128)).astype(np.float32) * 0.5
    for i, jp in ((0, jparams["prefix"][0]["attn"]),
                  (1, jax.tree.map(lambda a: a[0], jparams["blocks"][0]["attn"]))):
        with use_mesh(mesh):
            want = jattn.mla_forward(jnp.asarray(x), jp, jmodel.cfg)
            wq, wk, wv, _, _ = jattn.mla_qkv(jnp.asarray(x), jp, jmodel.cfg)
        tp = tparams["layers"][i]["attn"]
        got = tattn.mla_forward(torch.from_numpy(x), tp, tmodel.cfg)
        gq, gk, gv, _, _ = tattn.mla_qkv(torch.from_numpy(x), tp, tmodel.cfg)
        for w, g in ((want[0], got[0]), (want[1][0], got[1][0]), (want[1][1], got[1][1]),
                     (wq, gq), (wk, gk), (wv, gv)):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=TOL, atol=TOL)
        assert gv.data_ptr() != gv.contiguous().data_ptr()  # v is a view, not a copy


@pytest.mark.parametrize("latent", ["one_buffer", "separate"])
def test_mla_flash_decode_matches_the_reference(pair, latent):
    """The absorbed decode over a 64-slot latent cache at pos 0, 1, the
    middle and the last slot, against the reference's shard_map on its 1 x 1
    mesh; the caches as ``init_cache`` gives them (two views of one buffer)
    and as two tensors."""
    jmodel, _, tmodel, _, mesh = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(64)
    b, s, h, r, rope = 3, 64, cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    q_lat = rng.standard_normal((b, h, r)).astype(np.float32)
    q_pe = rng.standard_normal((b, h, rope)).astype(np.float32)
    buf = rng.standard_normal((b, s, r + rope)).astype(np.float32)
    t_buf = torch.from_numpy(buf)
    ckv, kpe = t_buf[..., :r], t_buf[..., r:]
    if latent == "separate":
        ckv, kpe = ckv.contiguous(), kpe.contiguous()
    for pos in (0, 1, s // 2, s - 1):
        with use_mesh(mesh):
            want = jattn.mla_flash_decode(jnp.asarray(q_lat), jnp.asarray(q_pe),
                                          jnp.asarray(buf[..., :r]), jnp.asarray(buf[..., r:]),
                                          jnp.int32(pos), jmodel.ax, mesh)
        got = tlm.mla_flash_decode(torch.from_numpy(q_lat), torch.from_numpy(q_pe), ckv, kpe,
                                   pos)
        assert got.shape == (b, h, r)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)


def test_latent_buffer_is_a_view_of_the_model_cache():
    model = Model(tconfigs.get_reduced_config(ARCH), "cpu")
    cache = model.init_cache(2, 10)
    assert [sorted(c) for c in cache] == [["ckv", "kpe"]] * model.cfg.num_layers
    c = cache[0]
    assert c["ckv"].shape == (2, 10, 32) and c["kpe"].shape == (2, 10, 16)
    buf = tattn.latent_buffer(c["ckv"], c["kpe"])
    assert buf.shape == (2, 10, 48) and buf.data_ptr() == c["ckv"].data_ptr()
    c["kpe"][1, 3] = 7.0
    assert bool((buf[1, 3, 32:] == 7.0).all())
    apart = tattn.latent_buffer(c["ckv"].clone(), c["kpe"].clone())
    assert torch.equal(apart, buf) and apart.data_ptr() != buf.data_ptr()


# -------------------------------------------------------- the reduced model
def test_forward_logits_and_router_loss_match(pair):
    jmodel, jparams, tmodel, tparams, mesh = pair
    toks = _tokens(tmodel.cfg, 2, 24, seed=0)
    with use_mesh(mesh):
        want, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=1e-12)
    assert float(aux) > 0


def test_decode_steps_match_over_a_whole_cache(pair, jax_step):
    """Twelve decode steps from an empty 12-slot cache (the last writes the
    last slot) at B=3, the logits of each within 1e-4; each step writes slot
    ``pos`` of every layer's latent cache and no other."""
    jmodel, jparams, tmodel, tparams, mesh = pair
    toks = _tokens(tmodel.cfg, 3, 12, seed=1)
    jcache = jmodel.init_cache(3, 12)
    tcache = tmodel.init_cache(3, 12)
    for pos in range(toks.shape[1]):
        want, jcache = jax_step(jparams, jcache, toks[:, pos : pos + 1], pos)
        before = [c["ckv"].clone() for c in tcache]
        got, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, pos : pos + 1]),
                                         pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
        for c, b in zip(tcache, before):
            assert (c["ckv"] != b).flatten(2).any(-1).any(0).nonzero().flatten().tolist() == [pos]
    jc = [jcache["prefix"][0]] + [jax.tree.map(lambda a, i=i: a[i], jcache["blocks"][0])
                                  for i in range(tmodel.cfg.n_blocks)]
    for t, j in zip(tcache, jc):
        for name in ("ckv", "kpe"):
            np.testing.assert_allclose(t[name].numpy(), _np(j[name]), rtol=TOL, atol=TOL)


def test_greedy_tokens_equal_the_reference(pair, jax_step):
    """The reference launcher's loop (prefill through decode steps, then
    greedy argmax) against the port's ``serve``."""
    jmodel, jparams, tmodel, tparams, mesh = pair
    prompts = np.random.default_rng(0).integers(2, tmodel.cfg.vocab_size, (2, 6))
    cache = jmodel.init_cache(2, 11)
    for pos in range(prompts.shape[1]):
        logits, cache = jax_step(jparams, cache, prompts[:, pos : pos + 1], pos)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(4):
        logits, cache = jax_step(jparams, cache, tok, 6 + i)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        want.append(tok)
    got, _ = serve(tmodel, tparams, torch.from_numpy(prompts), 5)
    np.testing.assert_array_equal(got.numpy(), np.concatenate([np.asarray(t) for t in want], 1))


def test_decode_path_reads_wkv_b_as_the_reference_does():
    """The reference's forward reads ``wkv_b`` a head at a time (``[nope +
    v_head_dim]`` columns a head) and its absorbed decode step as two halves
    (every head's ``nope`` columns, then every head's value columns), so its
    decode path's logits are not its forward's even with no MoE layer (whose
    capacity differs between the two). The port copies both reads: each
    path equals the reference's within 1e-4, and the gap between them is
    the reference's own."""
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(ARCH), prefix=(),
                               block=(JaxLayerSpec("attn", "dense"),), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(ARCH), prefix=(),
                               block=(LayerSpec("attn", "dense"),), dtype="float32")
    mesh = _mesh()
    jmodel = JaxModel(jcfg, Axes(dp=("data",), tp="model"), mesh)
    with use_mesh(mesh):
        jparams = jmodel.init(jax.random.key(1))
    tmodel = Model(tcfg, "cpu")
    tparams = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    toks = _tokens(tcfg, 2, 4, seed=9)
    with use_mesh(mesh):
        jfull, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
        step = jax.jit(jmodel.decode_step)
        jcache = jmodel.init_cache(2, 4)
        for pos in range(4):
            jlast, jcache = step(jparams, jcache, jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                                 jnp.int32(pos))
    tfull, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    tcache = tmodel.init_cache(2, 4)
    for pos in range(4):
        tlast, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, pos:pos + 1]),
                                           pos)
    np.testing.assert_allclose(tfull.numpy(), _np(jfull), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), rtol=TOL, atol=TOL)
    gap = np.abs(_np(jlast)[:, 0] - _np(jfull)[:, -1]).max()
    assert gap > 1e-2  # the two reads of wkv_b disagree in the reference
    np.testing.assert_allclose(np.abs(tlast[:, 0].numpy() - tfull[:, -1].numpy()).max(), gap,
                               rtol=1e-3)


def test_loss_and_every_gradient_leaf_match(pair):
    """One forward plus token cross-entropy and the router loss: the loss,
    its ``ce``, and every gradient leaf in JAX's order (the prefix layer's
    first), MLA's seven weights among them."""
    jmodel, jparams, tmodel, tparams, mesh = pair
    rng = np.random.default_rng(4)
    inputs = {"tokens": rng.integers(0, 512, (2, 16)), "labels": rng.integers(0, 512, (2, 16))}
    with use_mesh(mesh):
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(ref_make_loss_fn(jmodel),
                                                               has_aux=True))(
            jparams, {k: jnp.asarray(v, jnp.int32) for k, v in inputs.items()})
    leaves, treedef = tree_flatten(tparams)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = make_loss_fn(tmodel)(tree_unflatten(treedef, leaves),
                                         {k: torch.from_numpy(v) for k, v in inputs.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jmetrics["ce"]), rtol=TOL)
    port = tree_leaves(lm_params_to_reference(tmodel.cfg, tree_unflatten(treedef, grads)))
    ref = jax.tree.leaves(jgrads)
    assert len(port) == len(ref)
    for got, want in zip(port, ref):
        want = _np(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * max(
            1.0, float(np.abs(want).max())))
    names = {k for k in tparams["layers"][0]["attn"]}
    assert names == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_layers_round_trip_through_convert(dtype):
    """``lm_params_from_arrays`` puts the prefix layer first;
    ``lm_params_to_reference`` splits it back out, a tuple of one per-layer
    dict beside the stacked blocks, leaf for leaf in JAX's order and of the
    reference's structure; a tree with the wrong prefix count raises."""
    jmodel, jparams, tmodel, tparams, _ = _models(dtype)
    cfg = tmodel.cfg
    assert len(tparams["layers"]) == cfg.num_layers == 1 + cfg.n_blocks
    assert "ffn" in tparams["layers"][0] and "moe" in tparams["layers"][1]
    back = lm_params_to_reference(cfg, tparams)
    assert isinstance(back["prefix"], tuple) and len(back["prefix"]) == 1
    assert jax.tree.structure(jax.tree.map(lambda a: 0, jparams)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, back))
    got, want = tree_leaves(back), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(), _np(w))
    again = lm_params_from_arrays(cfg, back, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(tparams)))
    arrays = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="prefix"):
        lm_params_from_arrays(cfg, dict(arrays, prefix=()), "cpu")
    with pytest.raises(ValueError, match="layers"):
        lm_params_to_reference(cfg, dict(tparams, layers=tparams["layers"][1:]))


def test_checkpoint_leaves_cross_both_ways(tmp_path):
    """A bf16 model's state with bf16 AdamW moments (the config's
    ``opt_state_dtype``) saved by the reference restores in the port leaf
    for leaf, the prefix layer's included, and the port's save restores in
    the reference."""
    jmodel, jp, tmodel, _, mesh = _models("bfloat16")
    tcfg = tmodel.cfg
    state_dtype = jnp.dtype(tcfg.opt_state_dtype)
    jo = dataclasses.replace(
        ref_adamw_init(jp, state_dtype), step=jnp.int32(5),
        m=jax.tree.map(lambda a: (a * 0.5).astype(state_dtype), jp),
        v=jax.tree.map(lambda a: (a * a).astype(state_dtype), jp))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, (jp, jo))
    p0 = tmodel.init(torch.Generator().manual_seed(0))
    params, opt, step = train_mod.restore(str(tmp_path / "ref"), tcfg, p0,
                                          adamw_init(p0, tcfg.opt_state_dtype), "cpu")
    assert step == 5 and int(opt.step) == 5
    ref_leaves = jax.tree.leaves((jp, jo))
    port_tree = train_mod.checkpoint_tree(tcfg, params, opt)
    assert len(tree_leaves(port_tree)) == len(ref_leaves)
    for got, want in zip(tree_leaves(port_tree), ref_leaves):
        assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    ckpt.save_checkpoint(str(tmp_path / "port"), 6, port_tree)
    (rp, ro), rstep = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), (jp, jo))
    assert rstep == 6
    for got, want in zip(jax.tree.leaves((rp, ro)), ref_leaves):
        np.testing.assert_array_equal(_np(got), _np(want))


def test_init_matches_the_reference_layout(pair):
    _, _, tmodel, tparams, _ = pair
    own = tmodel.init(torch.Generator().manual_seed(0))
    flat_own, flat_ref = tree_leaves(own), tree_leaves(tparams)
    assert len(flat_own) == len(flat_ref)
    for a, b in zip(flat_own, flat_ref):
        assert a.shape == b.shape and a.dtype == b.dtype
    for key in ("kv_norm", "q_norm"):
        assert torch.equal(own["layers"][0]["attn"][key], tparams["layers"][0]["attn"][key])


def test_serve_launcher_on_cpu(capsys):
    gen = serve_main(["--arch", f"reduced:{ARCH}", "--batch", "2", "--prompt-len", "5",
                      "--gen", "4", "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert "generated token ids" in capsys.readouterr().out
    gen = serve_main(["--arch", f"reduced:{ARCH}", "--batch", "1", "--prompt-len", "3",
                      "--gen", "2", "--device", "cpu", "--n-blocks", "1"])
    assert gen.shape == (1, 2)
