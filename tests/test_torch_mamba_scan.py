"""The selective-scan kernel's plain version (``repro_torch.kernels.mamba_scan``)
against the reference on the CPU: ``selective_scan_pallas`` in interpret mode
and ``selective_scan_ref`` at ``tests/test_kernels.py``'s shapes, and the
model's ``_ssm_scan_chunked`` plus the ``D`` skip (what ``mamba_forward``
computes where the port calls the kernel).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are ``tests/test_kernels.py``'s: 1e-4 in float32 (exp and sums in
another order, compounded over T steps), 3e-2 in bf16 (bf16 inputs and
output). The CUDA kernel itself is held against this plain version on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
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
