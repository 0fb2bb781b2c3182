"""The selective-scan kernel's plain version (``repro_torch.kernels.mamba_scan``)
against the reference on the CPU: ``selective_scan_pallas`` in interpret mode
and ``selective_scan_ref`` at ``tests/test_kernels.py``'s shapes, and the
model's ``_ssm_scan_chunked`` plus the ``D`` skip (what ``mamba_forward``
computes where the port calls the kernel); and ``_scan_model``, a
plain-torch model of the kernel's split of the states over threads and its
exp2 with log2(e) folded into A, against both.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are ``tests/test_kernels.py``'s: 1e-4 in float32 (exp and sums in
another order, compounded over T steps), 3e-2 in bf16 (bf16 inputs and
output). The CUDA kernel itself is held against this plain version on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ops import selective_scan as jax_selective_scan
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_scan_ref
from repro.models.mamba import _ssm_scan_chunked
from repro_torch.kernels.mamba_scan import ops

SHAPES = [(1, 16, 64, 8), (2, 32, 128, 16), (2, 8, 512, 16)]  # bsz, t, d, n
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(bsz, t, d, n):
    """tests/test_kernels.py's inputs: x, dt, b, c in the working dtype, a
    and d_skip in float32."""
    rng = np.random.default_rng(d + t)
    return {
        "x": rng.standard_normal((bsz, t, d)),
        "dt": np.abs(rng.standard_normal((bsz, t, d))) * 0.1 + 0.01,
        "a": -np.abs(rng.standard_normal((d, n))) - 0.1,
        "b": rng.standard_normal((bsz, t, n)),
        "c": rng.standard_normal((bsz, t, n)),
        "d_skip": rng.standard_normal(d),
    }


def _both(arrays: dict, dtype: str):
    jx, tt = [], []
    for name, a in arrays.items():
        dt = "float32" if name in ("a", "d_skip") else dtype
        a32 = a.astype(np.float32)
        jx.append(jnp.asarray(a32, getattr(jnp, dt)))
        tt.append(torch.from_numpy(a32).to(getattr(torch, dt)))
    return jx, tt


def _assert_close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,t,d,n", SHAPES)
def test_plain_version_matches_pallas_interpret(bsz, t, d, n, dtype):
    jx, tt = _both(_inputs(bsz, t, d, n), dtype)
    y_want, h_want = jax_selective_scan(*jx, use_pallas=True, interpret=True, block_d=64)
    y, h = ops.selective_scan(*tt)
    assert y.dtype == tt[0].dtype and h.dtype == torch.float32 and h.shape == (bsz, d, n)
    _assert_close(y, y_want, TOL[dtype])
    _assert_close(h, h_want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,t,d,n", SHAPES)
def test_plain_version_matches_selective_scan_ref(bsz, t, d, n, dtype):
    jx, tt = _both(_inputs(bsz, t, d, n), dtype)
    y_want, h_want = jax_scan_ref(*jx)
    y, h = ops.selective_scan(*tt)
    _assert_close(y, y_want, TOL[dtype])
    _assert_close(h, h_want, TOL[dtype])


@pytest.mark.parametrize("chunk", [4, 512])
@pytest.mark.parametrize("bsz,t,d,n", SHAPES)
def test_plain_version_matches_chunked_scan_plus_skip(bsz, t, d, n, chunk):
    jx, tt = _both(_inputs(bsz, t, d, n), "float32")
    x, dt, a, b, c, d_skip = jx
    want = _ssm_scan_chunked(x, dt, a, b, c, chunk=chunk) + x * d_skip[None, None, :]
    y, _ = ops.selective_scan(*tt)
    _assert_close(y, want, 1e-4)


def _scan_model(x, dt, a, b, c, d_skip, states=ops.STATES_PER_THREAD):
    """A plain-torch model of ``csrc/mamba_scan.cu``'s arithmetic, in
    float32: A scaled by log2(e) once, each exponential exp2(dt * A log2 e);
    a thread holds ``states`` consecutive states of one channel and sums
    h * C over them in order each step, the first thread starting from the
    D skip; y is the threads' partial sums in state order."""
    bsz, t, d = x.shape
    n = a.shape[1]
    s = min(states, n)
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    a2 = a.float() * torch.tensor(math.log2(math.e), dtype=torch.float32)
    h = torch.zeros((bsz, d, n), dtype=torch.float32)
    ys = []
    for i in range(t):
        h = torch.exp2(dtf[:, i, :, None] * a2) * h \
            + (dtf[:, i] * xf[:, i])[:, :, None] * bf[:, i, None, :]
        prod = (h * cf[:, i, None, :]).reshape(bsz, d, n // s, s)
        part = torch.zeros_like(prod[..., 0])
        part[..., 0] = xf[:, i] * d_skip.float()
        for j in range(s):
            part = part + prod[..., j]
        y = part[..., 0]
        for g in range(1, n // s):
            y = y + part[..., g]
        ys.append(y)
    y = torch.stack(ys, 1) if ys else xf.new_zeros((bsz, 0, d))
    return y.to(x.dtype), h


@pytest.mark.parametrize("states", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,t,d,n", SHAPES)
def test_kernel_model_matches_plain_version_and_reference(bsz, t, d, n, dtype, states):
    """The kernel's split of the states over threads and its folded log2(e),
    at every states-per-thread the kernel can be built with, against the
    plain version and the reference's ``selective_scan_ref``."""
    jx, tt = _both(_inputs(bsz, t, d, n), dtype)
    y, h = _scan_model(*tt, states=states)
    y_plain, h_plain = ops.selective_scan(*tt)
    _assert_close(y, y_plain.float().numpy(), TOL[dtype])
    _assert_close(h, h_plain.numpy(), TOL[dtype])
    y_want, h_want = jax_scan_ref(*jx)
    _assert_close(y, y_want, TOL[dtype])
    _assert_close(h, h_want, TOL[dtype])


@pytest.mark.parametrize("n", [8, 16])
def test_kernel_model_long_scan_with_the_models_a(n):
    """T = 2048 with the model's A = -(1..N) on every channel, in float32."""
    rng = np.random.default_rng(2048 + n)
    d = 64
    arrays = {
        "x": rng.standard_normal((1, 2048, d)),
        "dt": np.abs(rng.standard_normal((1, 2048, d))) * 0.1 + 0.01,
        "a": -np.broadcast_to(np.arange(1, n + 1), (d, n)),
        "b": rng.standard_normal((1, 2048, n)),
        "c": rng.standard_normal((1, 2048, n)),
        "d_skip": rng.standard_normal(d),
    }
    jx, tt = _both(arrays, "float32")
    y, h = _scan_model(*tt)
    y_plain, h_plain = ops.selective_scan(*tt)
    _assert_close(y, y_plain.numpy(), TOL["float32"])
    _assert_close(h, h_plain.numpy(), TOL["float32"])
    y_want, _ = jax_scan_ref(*jx)
    _assert_close(y, y_want, TOL["float32"])


def test_split_constants_match_the_kernel_source():
    src = (Path(ops.__file__).parent / "csrc" / "mamba_scan.cu").read_text()
    assert f"constexpr int kStates = {ops.STATES_PER_THREAD};" in src
    assert all(n % ops.STATES_PER_THREAD == 0 or ops.STATES_PER_THREAD > n
               for n in ops.STATE_SIZES)


def test_wrapper_checks_and_counts_no_cpu_launch():
    _, (x, dt, a, b, c, d_skip) = _both(_inputs(1, 4, 16, 8), "float32")
    before = ops.launches
    y, h = ops.selective_scan(x, dt, a, b, c, d_skip)
    assert ops.launches == before and y.shape == x.shape and h.shape == (1, 16, 8)
    with pytest.raises(ValueError, match="shapes disagree"):
        ops.selective_scan(x, dt, a, b[:, :3].contiguous(), c, d_skip)
    with pytest.raises(TypeError, match="must be torch.float32"):
        ops.selective_scan(x, dt, a.double(), b, c, d_skip)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        ops.selective_scan(x.bfloat16(), dt, a, b, c, d_skip)
    strided = torch.zeros(1, 4, 32)[..., :16].copy_(x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.selective_scan(strided, dt, a, b, c, d_skip)
