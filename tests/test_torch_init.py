"""The per-module initialisers (ROADMAP Queue 1 item 10d) against the
reference's, and ``Model.init``'s numbers pinned.

``init_layer`` (through ``init_attention``, ``init_mamba``,
``init_dense_ffn``, ``init_moe`` and ``init_rmsnorm``) gives the
reference's ``init_layer`` leaf layout, shapes and dtypes for every layer
kind of the ten configs (GQA, sliding window, gated cross-attention, MLA,
Mamba; dense, MoE, dense + MoE and no FFN). ``Model.init`` builds its
leaves through them and draws its random numbers in the order it did
before they existed: the digests below were taken from ``Model(cfg,
device="cpu").init(torch.Generator().manual_seed(0))`` on the tree before
the initialisers, so every seeded figure of earlier slices stays valid.
"""
import hashlib

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jconfigs
from repro.models.model import init_layer as jax_init_layer
import repro_torch.configs as tconfigs
from repro_torch.launch.train import repro_100m
from repro_torch.models.layers import Init, init_dense_ffn, init_moe, init_rmsnorm
from repro_torch.models.model import Model, init_layer
from repro_torch.train.pytree import tree_flatten

ARCHS = list(jconfigs.ALIASES)

# sha256 (first 16 hex digits) over each leaf's shape, dtype and bytes in
# tree order, of Model.init(torch.Generator().manual_seed(0)) on the CPU
INIT_DIGESTS = {
    "reduced:qwen3-8b": "8ac4f48ecb3f25f5",
    "reduced:falcon-mamba-7b": "680ef1513491c4cd",
    "reduced:minitron-8b": "819d62d7e3a89c7e",
    "reduced:deepseek-coder-33b": "12f070077f17b65f",
    "reduced:jamba-v0.1-52b": "8af2ea0ca9830dd2",
    "reduced:arctic-480b": "016c5e4d12c9773b",
    "reduced:gemma3-12b": "66c5ece7bced35cf",
    "reduced:hubert-xlarge": "51d97ffe7530f624",
    "reduced:llama-3.2-vision-90b": "37664bc41aad8e73",
    "reduced:deepseek-v2-236b": "098827ec92db5f41",
    "repro-100m": "9ab5e9f86675b4d3",
}


def _digest(params) -> str:
    h = hashlib.sha256()
    leaves, _ = tree_flatten(params)
    for t in leaves:
        t = t.detach().cpu().contiguous()
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.uint8)
        h.update(raw.numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", list(INIT_DIGESTS))
def test_model_init_draws_as_before(name):
    cfg = repro_100m() if name == "repro-100m" else tconfigs.get_model_config(name)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert _digest(params) == INIT_DIGESTS[name]


def _layout(tree):
    """``{path: (shape, dtype name)}`` of a tree of tensors or
    ShapeDtypeStructs."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        else:
            dtype = str(t.dtype).replace("torch.", "") if isinstance(t, torch.Tensor) \
                else jnp.dtype(t.dtype).name
            out[path] = (tuple(t.shape), dtype)

    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layer_layout_equals_the_reference(arch):
    """Every distinct layer kind of the full config (its widths) and of the
    reduced one."""
    for jcfg, tcfg in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                       (jconfigs.get_reduced_config(arch), tconfigs.get_reduced_config(arch))):
        for spec in dict.fromkeys(tcfg.layers()):
            want = jax.eval_shape(lambda k, s=spec: jax_init_layer(k, s, jcfg),
                                  jax.random.key(0))
            got = init_layer(Init.shapes(), spec, tcfg)
            assert _layout(got) == _layout(want), (arch, spec)


def test_init_functions_draw_in_order_and_shapes_allocate_nothing():
    """One generator through ``init_rmsnorm``, ``init_dense_ffn`` and
    ``init_moe``: the dense FFN draws ``w_in``, ``w_out``, then ``w_gate``;
    the MoE its float32 router first. ``Init.shapes()`` gives ``meta``
    tensors and draws nothing."""
    g = torch.Generator().manual_seed(5)
    init = Init(g, "cpu")
    norm = init_rmsnorm(init, 8, torch.float32)
    ffn = init_dense_ffn(init, 8, 16, "swiglu", torch.float32)
    moe = init_moe(init, 8, 4, 3, 1, "swiglu", torch.bfloat16)
    assert torch.equal(norm["scale"], torch.ones(8))
    g2 = torch.Generator().manual_seed(5)
    w_in = torch.randn((8, 16), generator=g2) * 8**-0.5
    w_out = torch.randn((16, 8), generator=g2) * 16**-0.5
    w_gate = torch.randn((8, 16), generator=g2) * 8**-0.5
    router = torch.randn((8, 3), generator=g2) * 8**-0.5
    for got, want in ((ffn["w_in"], w_in), (ffn["w_out"], w_out), (ffn["w_gate"], w_gate),
                      (moe["router"], router)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert moe["router"].dtype == torch.float32 and moe["w_in"].dtype == torch.bfloat16
    assert set(moe["shared"]) == {"w_in", "w_out", "w_gate"}
    shapes = init_moe(Init.shapes(), 5120, 1536, 160, 2, "swiglu", torch.bfloat16)
    assert shapes["w_in"].device.type == "meta" and tuple(shapes["w_in"].shape) == (160, 5120,
                                                                                   1536)
