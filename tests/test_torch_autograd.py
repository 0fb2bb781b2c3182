"""The gradient that the attention and scan wrappers give on the card, checked
on the CPU through their autograd Functions.

A CUDA kernel writes into a fresh ``torch.empty`` that autograd knows nothing
of, so a launch alone hands back an output without a ``grad_fn``: the
gradient to everything before the kernel is cut without a word. Each wrapper
therefore runs the launch inside a ``torch.autograd.Function`` whose backward
differentiates the kernel's plain version on the saved inputs. On the CPU
the wrappers call the plain versions directly, so these tests stand a plain
no-grad forward in for the launch (``ops._launch``, patched) and drive the
Functions as the card does. The card itself runs the same checks in
``tests/test_torch_gpu.py``. The Functions' backward is the plain version's
own autograd, so the gradients must equal plain autograd exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mamba_scan import ops as scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref


def _no_grad(fn):
    def launch(*args):
        with torch.no_grad():
            return fn(*args)
    return launch


@pytest.fixture
def plain_launches(monkeypatch):
    """The kernels' launches replaced by their plain versions, run without
    autograd as a kernel would."""
    monkeypatch.setattr(fa, "_launch", _no_grad(flash_attention_ref))
    monkeypatch.setattr(scan, "_launch", _no_grad(selective_scan_ref))


def _leaf(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale) \
        .to(dtype).requires_grad_(True)


def _attention_inputs(dtype, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [_leaf(rng, (2, 4, 48, dh), dtype), _leaf(rng, (2, 2, 48, dh), dtype),
            _leaf(rng, (2, 2, 48, dh), dtype)]


def test_a_launch_alone_drops_the_gradient(plain_launches):
    """The fault the Functions repair: the output of a bare launch has no
    ``grad_fn`` although its inputs need a gradient."""
    q, k, v = _attention_inputs(torch.float32, 32)
    assert fa._launch(q, k, v, True, None, 0).grad_fn is None
    y, h = scan._launch(*_scan_inputs(torch.float32))
    assert y.grad_fn is None and h.grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (True, 16, 0),
                                                    (False, None, 0), (True, None, 5)])
def test_attention_function_gradient_is_plain_autograd(plain_launches, dtype, dh, causal, window,
                                                       q_offset):
    q, k, v = _attention_inputs(dtype, dh)
    out = fa._FlashAttention.apply(q, k, v, causal, window, q_offset)
    assert out.grad_fn is not None and out.dtype == dtype
    grad_out = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape)
                                .astype(np.float32)).to(dtype)
    got = torch.autograd.grad(out, (q, k, v), grad_out)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal, window, q_offset),
                               (q, k, v), grad_out)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(g, w)


def test_attention_function_only_computes_the_gradients_asked_for(plain_launches):
    q, k, v = _attention_inputs(torch.float32, 64)
    k = k.detach()
    out = fa._FlashAttention.apply(q, k, v, True, None, 0)
    gq, gv = torch.autograd.grad(out.sum(), (q, v))
    wq, wv = torch.autograd.grad(flash_attention_ref(q, k, v).sum(), (q, v))
    assert torch.equal(gq, wq) and torch.equal(gv, wv)


def test_attention_function_refuses_a_second_derivative(plain_launches):
    q, k, v = _attention_inputs(torch.float32, 32)
    out = fa._FlashAttention.apply(q, k, v, True, None, 0)
    (gq,) = torch.autograd.grad(out.square().sum(), (q,), create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), (q,))


def _scan_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    bsz, t, d, n = 2, 12, 8, 16
    x = _leaf(rng, (bsz, t, d), dtype)
    dt = torch.nn.functional.softplus(_leaf(rng, (bsz, t, d), torch.float32)).to(dtype)
    a = -torch.exp(_leaf(rng, (d, n), torch.float32, 0.5))
    b = _leaf(rng, (bsz, t, n), dtype)
    c = _leaf(rng, (bsz, t, n), dtype)
    d_skip = _leaf(rng, (d,), torch.float32)
    return x, dt, a, b, c, d_skip


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_h", [False, True])
def test_scan_function_gradient_is_plain_autograd(plain_launches, dtype, use_h):
    inputs = _scan_inputs(dtype)
    y, h = scan._SelectiveScan.apply(*inputs)
    assert y.grad_fn is not None and h.grad_fn is not None
    loss = (y.float() * torch.linspace(-1, 1, y.shape[-1])).sum() + (h.sum() if use_h else 0)
    got = torch.autograd.grad(loss, inputs)
    wy, wh = selective_scan_ref(*inputs)
    want_loss = (wy.float() * torch.linspace(-1, 1, wy.shape[-1])).sum() + (
        wh.sum() if use_h else 0)
    want = torch.autograd.grad(want_loss, inputs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrappers_keep_the_plain_path_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions, gradient and all."""
    q, k, v = _attention_inputs(torch.float32, 32)
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    y, h = scan.selective_scan(*_scan_inputs(torch.float32))
    assert y.grad_fn is not None and h.grad_fn is not None
