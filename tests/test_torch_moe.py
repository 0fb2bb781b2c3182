"""The port's one-card MoE layer against the reference's expert-parallel
``moe_ffn`` on a 1 x 1 mesh (where its all-to-alls are the identity), on
the CPU.

Both packages get the same numpy-seeded weights and inputs. In float32 the
outputs, the aux loss and the gradients agree within 1e-5 (the same
float32 operations; a sum may run in another order) in three regimes: the
prefill capacity, a ``capacity_factor`` small enough to drop most (token,
slot) pairs, and a decode batch at ``cap = 1``. The routing itself
(positions in an expert, top-k order, capacity) is held with ``==``.
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
from repro.models import layers as jlayers
import repro_torch.configs as tconfigs
from repro_torch.models import layers as tlayers

TOL = 1e-5


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _cfgs(arch="jamba-v0.1-52b", **changes):
    """Reduced configs of both packages (E=8, top-2, D=128, F=128)."""
    changes = {"dtype": "float32", **changes}
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), **changes)
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(arch), **changes)
    return jcfg, tcfg


def _weights(cfg, seed=0, shared=False):
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert or cfg.d_ff

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = {"router": normal((d, e), d**-0.5), "w_in": normal((e, d, f), d**-0.5),
         "w_gate": normal((e, d, f), d**-0.5), "w_out": normal((e, f, d), f**-0.5)}
    if shared:
        w["shared"] = {"w_in": normal((d, f), d**-0.5), "w_gate": normal((d, f), d**-0.5),
                       "w_out": normal((f, d), f**-0.5)}
    return w


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _reference(jcfg, w, x):
    """The reference's layer, jitted (its shard_map runs op by op otherwise)."""
    mesh = _mesh()
    fn = jax.jit(lambda x, w: jlayers.moe_ffn(x, w, jcfg, Axes(dp=("data",), tp="model"), mesh))
    with use_mesh(mesh):
        y, aux = fn(jnp.asarray(x), _to(w, jnp.asarray))
    return np.asarray(y), float(aux)


def _port(tcfg, w, x):
    y, aux = tlayers.moe_ffn(torch.from_numpy(x), _to(w, torch.from_numpy), tcfg)
    return y.numpy(), float(aux)


def _kept(cfg, x, w):
    """How many of the B*S*k (token, slot) pairs the capacity keeps."""
    tl = x.shape[0] * x.shape[1]
    tokens = torch.from_numpy(x.reshape(tl, -1))
    probs = torch.softmax(tokens @ torch.from_numpy(w["router"]), dim=-1)
    _, idx = tlayers.top_k(probs, cfg.top_k)
    pos = tlayers.positions_in_expert(idx.reshape(-1), cfg.n_experts)
    return int((pos < tlayers.moe_capacity(tl, cfg)).sum()), tl * cfg.top_k


# (batch, seq, changes, expected capacity): the prefill floor of 8, a
# capacity_factor that drops most pairs, the decode floor of 1
REGIMES = {
    "prefill": (2, 32, {}, 20),
    "drops": (2, 32, {"capacity_factor": 0.25}, 8),
    "decode_cap1": (8, 1, {"n_experts": 16}, 1),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_moe_ffn_matches_the_reference(regime):
    b, s, changes, cap = REGIMES[regime]
    jcfg, tcfg = _cfgs(**changes)
    assert tlayers.moe_capacity(b * s, tcfg) == cap
    w, x = _weights(tcfg), _x(tcfg, b, s)
    kept, pairs = _kept(tcfg, x, w)
    if regime == "prefill":
        assert kept == pairs  # nothing dropped at the prefill capacity
    else:
        assert kept < pairs  # the regime drops pairs, as the reference does
    want, jaux = _reference(jcfg, w, x)
    got, taux = _port(tcfg, w, x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(taux, jaux, rtol=TOL)


def test_shared_experts_and_gelu_and_sq_relu():
    for act in ("swiglu", "gelu", "sq_relu"):
        jcfg, tcfg = _cfgs(n_shared_experts=1, activation=act)
        w = _weights(tcfg, seed=2, shared=True)
        if act != "swiglu":
            w.pop("w_gate")
            w["shared"].pop("w_gate")
        x = _x(tcfg, 2, 16, seed=3)
        want, jaux = _reference(jcfg, w, x)
        got, taux = _port(tcfg, w, x)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=act)
        np.testing.assert_allclose(taux, jaux, rtol=TOL)


def test_moe_gradients_match_jax_grad():
    """A loss of the output and the aux loss: gradients to x and to every
    weight equal ``jax.grad``'s, dropped pairs included."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    w, x = _weights(tcfg, seed=4, shared=False), _x(tcfg, 2, 32, seed=5)
    r = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    mesh = _mesh()
    ax = Axes(dp=("data",), tp="model")

    def jloss(x, w):
        y, aux = jlayers.moe_ffn(x, w, jcfg, ax, mesh)
        return jnp.sum(y * r) + 0.5 * aux

    with use_mesh(mesh):
        jgx, jgw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), _to(w, jnp.asarray))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = _to(w, lambda a: torch.from_numpy(a).requires_grad_(True))
    y, aux = tlayers.moe_ffn(tx, tw, tcfg)
    (torch.sum(y * torch.from_numpy(r)) + 0.5 * aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=TOL, atol=TOL)
    for k in w:
        np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(jgw[k]), rtol=1e-4,
                                   atol=TOL, err_msg=k)


def test_expert_slices_give_the_same_bits(monkeypatch):
    """The port upcasts the experts' weights a slice at a time; any slicing
    gives the whole axis's result bit for bit."""
    _, tcfg = _cfgs()
    w = _to(_weights(tcfg, seed=7), torch.from_numpy)
    x = torch.from_numpy(_x(tcfg, 2, 32, seed=8))
    whole, _ = tlayers.moe_ffn(x, w, tcfg)
    for per in (1, 3):  # experts per slice
        monkeypatch.setattr(tlayers, "EXPERT_F32_BYTES", per * tcfg.d_model * 128 * 4)
        sliced, _ = tlayers.moe_ffn(x, w, tcfg)
        assert torch.equal(sliced, whole)


def test_bf16_experts_multiply_in_float32():
    """A bf16 layer: the expert products run on float32 copies of the bf16
    weights (exact products, float32 sums), the output is cast back."""
    _, tcfg = _cfgs(dtype="bfloat16")
    w = _to(_weights(tcfg, seed=9), lambda a: torch.from_numpy(a).to(torch.bfloat16))
    w["router"] = w["router"].float()
    grouped = torch.from_numpy(_x(tcfg, 8, 4, seed=10)).to(torch.bfloat16)
    got = tlayers.expert_products(grouped, w, "swiglu")
    assert got.dtype == torch.float32
    gf = grouped.double()
    h = gf @ w["w_in"].double()
    g = gf @ w["w_gate"].double()
    want = (torch.nn.functional.silu(g) * h) @ w["w_out"].double()
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    y, aux = tlayers.moe_ffn(torch.from_numpy(_x(tcfg, 2, 8)).to(torch.bfloat16), w, tcfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


@pytest.mark.parametrize("n,e", [(1, 4), (64, 8), (300, 16), (16, 16)])
def test_positions_in_expert_equal_the_reference(n, e):
    rng = np.random.default_rng(n + e)
    e_flat = rng.integers(0, e, n)
    want = np.asarray(jlayers._positions_in_expert(jnp.asarray(e_flat, jnp.int32), e))
    got = tlayers.positions_in_expert(torch.from_numpy(e_flat), e)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_breaks_ties_by_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.5, 0.0, 0.5, 0.0]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tlayers.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tokens,e,k,factor", [
    (8192, 16, 2, 1.25), (8192, 128, 2, 1.25), (8, 16, 2, 1.25), (8, 128, 2, 1.25),
    (64, 8, 2, 0.25), (3, 8, 2, 1.25), (32, 8, 6, 1.0),
])
def test_capacity_equals_the_reference_formula(tokens, e, k, factor):
    """The reference's ``cap`` (``layers.py:178-180``): jamba and arctic at
    prefill T=8192 (1,280 and 160 slots) and at the serve loop's B=8 (1)."""
    _, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=factor)
    floor = 8 if tokens * k >= 8 * e else 1
    assert tlayers.moe_capacity(tokens, tcfg) == int(max(floor, (-(-tokens * k // e)) * factor))
    if (tokens, k, factor) == (8192, 2, 1.25):
        assert tlayers.moe_capacity(tokens, tcfg) == {16: 1280, 128: 160}[e]
    if (tokens, k) == (8, 2):
        assert tlayers.moe_capacity(tokens, tcfg) == 1
