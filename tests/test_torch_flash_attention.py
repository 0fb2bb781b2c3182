"""The attention kernel's plain version (``repro_torch.kernels.flash_attention``)
against the reference on the CPU: ``attention_ref`` at every shape of
``tests/test_kernels.py`` and its decode-offset sweep, and the model code's
``_sdpa`` and ``_chunked_sdpa`` in the model's ``[B, T, H, Dh]`` layout.

Inputs are made with numpy from a seed and handed to both packages; bf16
inputs are rounded from the same float32 values by both. Tolerances are
``tests/test_kernels.py``'s: 2e-5 in float32 (sums in another order), 2e-2
in bf16 (one bf16 rounding of the output). The reference's own Pallas path
does not run on the installed jax (``pl.load`` is gone), so its oracle is
``attention_ref``. The CUDA kernel itself is held against this plain version
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The tensor-core variant's rounding is modelled here tile by tile
(``_tensor_core_model``) and held against the references at both bf16
tolerances before the card sees it; so is the split-KV decode kernel's
arithmetic (``_split_decode_model``: contiguous shares of the key tiles,
each share's float32 partial softmax, merged by the reference's
``gqa_flash_decode`` rule). The wrapper's variant dispatch and the decode
split count are pure functions of the inputs' dtype, shapes and alignment
and are tested here too.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import _chunked_sdpa, _sdpa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

KERNEL_SHAPES = [  # tests/test_kernels.py: b, hq, hkv, tq, tk, dh, causal, window
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),   # GQA
    (1, 2, 1, 256, 256, 32, False, None),  # bidirectional
    (1, 2, 2, 128, 128, 64, True, 32),     # sliding window
    (2, 2, 2, 64, 64, 128, True, None),    # small seq
    # the slice-14 families' head dims and cross-attention shapes
    (1, 4, 2, 96, 96, 80, False, None),     # hubert-xlarge: Dh 80, bidirectional
    (1, 2, 1, 128, 128, 256, True, 64),     # gemma3-12b's local layers: Dh 256, a window
    (1, 8, 2, 8, 1024, 128, False, None),   # cross-attention: Tq 8 over 1,024 image tokens
    (2, 8, 2, 1, 1024, 128, False, None),   # its decode step: Tq 1
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(rng, b, hq, hkv, tq, tk, dh):
    return (rng.standard_normal((b, hq, tq, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, dh)).astype(np.float32))


def _both(arrays, dtype: str):
    """The same values as jax arrays and torch tensors of ``dtype``."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tt


def _assert_close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,window", KERNEL_SHAPES)
def test_plain_version_matches_attention_ref(b, hq, hkv, tq, tk, dh, causal, window, dtype):
    rng = np.random.default_rng(tq + dh)
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, b, hq, hkv, tq, tk, dh), dtype)
    want = attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (b, hq, tq, dh)
    _assert_close(got, want, TOL[dtype])


def test_decode_offset():
    """One-token decode against a long KV cache (q_offset = Tk-1)."""
    rng = np.random.default_rng(0)
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, 2, 4, 4, 1, 256, 64), "float32")
    want = attention_ref(jq, jk, jv, causal=True, q_offset=255)
    _assert_close(ops.flash_attention(q, k, v, causal=True, q_offset=255), want, 2e-5)


# the sweep of tests/test_kernels.py around the reference's kv-block boundary
@pytest.mark.parametrize("q_offset", [0, 1, 127, 128, 200])
@pytest.mark.parametrize("tq", [1, 4])
def test_decode_offset_sweep(q_offset, tq):
    rng = np.random.default_rng(q_offset * 7 + tq)
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, 2, 4, 4, tq, 256, 64), "float32")
    want = attention_ref(jq, jk, jv, causal=True, q_offset=q_offset)
    _assert_close(ops.flash_attention(q, k, v, causal=True, q_offset=q_offset), want, 2e-5)


# ragged Tk (not a multiple of the kernel's 64-row tiles) with every mask
@pytest.mark.parametrize("tq,tk,causal,window,q_offset", [
    (4, 200, True, None, 196),
    (16, 77, False, None, 0),
    (33, 130, True, 50, 97),
    (1, 1, True, None, 0),
    (70, 70, True, 1, 0),
])
def test_ragged_and_windowed(tq, tk, causal, window, q_offset):
    rng = np.random.default_rng(tq * 1000 + tk)
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, 1, 4, 2, tq, tk, 32), "float32")
    want = attention_ref(jq, jk, jv, causal=causal, window=window, q_offset=q_offset)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    _assert_close(got, want, 2e-5)


def _model_layout(rng, b, t, s, h, hkv, dh):
    return (rng.standard_normal((b, t, h, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32))


def _port_in_model_layout(q, k, v, **kw) -> torch.Tensor:
    """The port's attention on [B, T, H, Dh] tensors, as the model calls it:
    transposed views, no copy."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    return out.transpose(1, 2)


@pytest.mark.parametrize("b,t,h,hkv,dh,causal,window", [
    (2, 16, 4, 2, 32, True, None),
    (1, 48, 4, 1, 64, True, 16),
    (2, 20, 2, 2, 32, False, None),
    (1, 32, 8, 2, 128, True, None),
])
def test_matches_model_sdpa(b, t, h, hkv, dh, causal, window):
    rng = np.random.default_rng(b * 100 + t)
    arrays = _model_layout(rng, b, t, t, h, hkv, dh)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    want = _sdpa(jq, jk, jv, causal, window)
    _assert_close(_port_in_model_layout(q, k, v, causal=causal, window=window), want, 2e-5)


@pytest.mark.parametrize("t,h,hkv,causal,window", [
    (64, 4, 2, True, None),
    (48, 4, 4, True, 20),
    (32, 2, 1, False, None),
])
def test_matches_model_chunked_sdpa(t, h, hkv, causal, window):
    rng = np.random.default_rng(t + h)
    arrays = _model_layout(rng, 2, t, t, h, hkv, 32)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    want = _chunked_sdpa(jq, jk, jv, causal, window, chunk=16)
    _assert_close(_port_in_model_layout(q, k, v, causal=causal, window=window), want, 2e-5)


def test_strided_views_equal_contiguous_inputs():
    rng = np.random.default_rng(5)
    _, (q, k, v) = _both(_model_layout(rng, 2, 24, 24, 4, 2, 32), "float32")
    views = [t.transpose(1, 2) for t in (q, k, v)]
    dense = [t.contiguous() for t in views]
    assert not views[0].is_contiguous()
    assert torch.equal(ops.flash_attention(*views), flash_attention_ref(*dense))


def test_wrapper_checks_and_counts_no_cpu_launch():
    q = torch.zeros(1, 4, 8, 32)
    k = torch.zeros(1, 2, 8, 32)
    before = ops.launches
    assert ops.flash_attention(q, k, k).shape == (1, 4, 8, 32)
    assert ops.launches == before  # the plain version on the CPU is no launch
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="share dtype"):
        ops.flash_attention(q, k, k.double())
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention(q, k[..., :16], k[..., :16])


# --------------------------------------------------------- variant dispatch
@pytest.mark.parametrize("dtype,tq,group,dh,aligned,variant", [
    (torch.bfloat16, 8192, 4, 128, True, "wgmma_bf16"),  # qwen3-8b prefill
    (torch.bfloat16, 17, 1, 32, True, "wgmma_bf16"),     # the shortest tensor-core prefill
    (torch.bfloat16, 64, 2, 64, True, "wgmma_bf16"),
    (torch.float32, 8192, 4, 128, True, "fma"),        # float32 stays on FMA (2e-5)
    (torch.float32, 64, 1, 32, True, "fma"),
    (torch.bfloat16, 1, 4, 128, True, "decode_split"),  # a decode step
    (torch.bfloat16, 4, 4, 128, True, "decode_split"),  # g * Tq = 16
    (torch.bfloat16, 16, 1, 64, True, "decode_split"),
    (torch.float32, 1, 8, 32, True, "decode_split"),
    (torch.bfloat16, 1, 4, 128, False, "decode_split"),  # unaligned rows: element loads
    (torch.bfloat16, 5, 4, 128, True, "fma_short"),    # Tq <= 16, g * Tq > 16
    (torch.bfloat16, 16, 2, 64, True, "fma_short"),
    (torch.bfloat16, 8192, 4, 128, False, "fma"),      # unaligned rows
    (torch.bfloat16, 100, 1, 32, False, "fma"),
    (torch.bfloat16, 8192, 2, 256, True, "wgmma_bf16"),  # gemma3-12b prefill
    (torch.bfloat16, 1500, 1, 80, True, "wgmma_bf16"),   # hubert-xlarge, 30 s of frames
    (torch.bfloat16, 8192, 8, 128, True, "wgmma_bf16"),  # llama's cross prefill over Tk 1024
    (torch.bfloat16, 1, 2, 256, True, "decode_split"),   # gemma3 decode, the ring too
    (torch.bfloat16, 1, 8, 128, True, "decode_split"),   # llama's cross decode, g = 8
    (torch.float32, 8, 4, 80, True, "fma_short"),
    (torch.float32, 1500, 1, 80, True, "fma"),
    (torch.float32, 64, 2, 256, True, "fma"),
])
def test_kernel_variant_dispatch(dtype, tq, group, dh, aligned, variant):
    assert ops.kernel_variant(dtype, tq, group, dh, aligned) == variant
    assert variant in ops.VARIANTS


def test_every_variant_takes_every_head_dim():
    """Dh 80 (hubert-xlarge) and 256 (gemma3-12b) are built for every
    variant; a head dim that is not built raises before any launch."""
    assert ops.HEAD_DIMS == (32, 64, 80, 128, 256)
    for dh in ops.HEAD_DIMS:
        assert ops.kernel_variant(torch.bfloat16, 64, 1, dh, True) == "wgmma_bf16"
    assert ops.kernel_variant(torch.bfloat16, 64, 1, 96, True) == "fma"


def test_alignment_of_views():
    """Model-layout views are aligned; rows of 65 elements, a base one element
    in, or a head stride of 260 elements are not."""
    x = torch.zeros(2, 40, 8, 128, dtype=torch.bfloat16)
    assert ops.is_aligned(x.transpose(1, 2), x[:, :8].transpose(1, 2))
    wide = torch.zeros(1, 2, 100, 65, dtype=torch.bfloat16)
    assert not ops.is_aligned(wide[..., :64])
    flat = torch.zeros(8192, dtype=torch.bfloat16)
    assert ops.is_aligned(flat.as_strided((1, 2, 8, 32), (1024, 256, 32, 1)))
    assert not ops.is_aligned(flat[1:1 + 2 * 64 * 32].view(1, 2, 64, 32))
    assert not ops.is_aligned(flat.as_strided((1, 2, 8, 32), (1024, 260, 32, 1)))


def test_variant_counts_reset_and_stay_still_on_the_cpu():
    q = torch.zeros(1, 4, 64, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 64, 32, dtype=torch.bfloat16)
    ops.variant_launches["wgmma_bf16"] += 3
    ops.split_launches[4] = 2
    ops.reset()
    assert ops.launches == 0 and set(ops.variant_launches.values()) == {0}
    assert ops.split_launches == {}
    ops.flash_attention(q, k, k)
    ops.flash_attention(q[:, :, :1], k, k, q_offset=63)  # a decode step on the plain version
    assert set(ops.variant_launches.values()) == {0}  # the plain version is no launch
    assert ops.split_launches == {}


# ------------------------------------------- the tensor-core variant's arithmetic
def _tensor_core_model(q, k, v, causal=True, window=None, q_offset=0, block_k=64):
    """A plain-torch model of the tensor-core kernel's rounding: bf16 Q, K, V
    (exact in float32), S = Q K^T in float32, the online max/sum/rescale in
    float32 once per 64-key tile with the exponent taken in base 2 as
    ``exp2((s - max) * scale * log2(e))``, P rounded to bf16 before P V (its
    row sum taken from the float32 P), O in float32, rounded once."""
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, tq, dh)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    scale = dh**-0.5 * math.log2(math.e)
    qpos = torch.arange(tq)[:, None] + q_offset
    m = torch.full((b, hkv, hq // hkv, tq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for kbase in range(0, tk, block_k):
        kt, vt = kf[..., kbase:kbase + block_k, :], vf[..., kbase:kbase + block_k, :]
        kpos = torch.arange(kbase, kbase + kt.shape[-2])[None, :]
        s = qf @ kt.transpose(-1, -2)
        keep = torch.ones(tq, kt.shape[-2], dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        s = s.masked_fill(~keep, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * scale)
        p = torch.exp2((s - m_new) * scale)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(b, hq, tq, dh).bfloat16()


def _worst_row_rel_l2(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got, np.float32)), torch.as_tensor(
        np.asarray(want, np.float32))
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())


def _assert_bf16_gates(got: torch.Tensor, want):
    """chip_smoke.py's bf16 gates: 2e-2 elementwise, every row within 1e-2
    relative L2."""
    _assert_close(got, want, TOL["bfloat16"])
    assert _worst_row_rel_l2(got.float().numpy(), want) <= 1e-2


TENSOR_CORE_SHAPES = [s + (0,) for s in KERNEL_SHAPES] + [
    (2, 4, 2, 256, 256, 32, True, None, 0),   # the reduced qwen3-8b layer
    (1, 4, 2, 100, 333, 32, True, 50, 233),   # ragged chunked prefill under a window
    (1, 8, 2, 70, 70, 64, True, 1, 0),        # g = 4; each row sees itself only
]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,window,q_offset", TENSOR_CORE_SHAPES)
def test_tensor_core_rounding_within_the_bf16_gates(b, hq, hkv, tq, tk, dh, causal, window,
                                                    q_offset):
    """The model against the plain version, the reference's ``attention_ref``
    and the model code's ``_sdpa`` (in ``[B, T, H, Dh]``), each at both bf16
    gates."""
    rng = np.random.default_rng(tq + dh + q_offset)
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, b, hq, hkv, tq, tk, dh), "bfloat16")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _tensor_core_model(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_bf16_gates(got, flash_attention_ref(q, k, v, **kw).float().numpy())
    _assert_bf16_gates(got, attention_ref(jq, jk, jv, **kw))
    to_model = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731
    want = _sdpa(to_model(jq), to_model(jk), to_model(jv), causal, window, q_offset)
    _assert_bf16_gates(got, to_model(want))


# ------------------------------------------- the split-KV decode kernel's arithmetic
def _split_decode_model(q, k, v, causal=True, window=None, q_offset=0, n_split=1,
                        block_k=64):
    """A plain-torch model of the decode kernel: the key tiles [lo, hi) that
    the Pallas loop bounds give the Tq rows are cut into ``n_split``
    contiguous shares; each share takes its float32 (m, l, o) with masked
    scores at -1e30 over its tiles (keys past Tk padded with zeros and
    masked), an empty share (m, l, o) = (-inf, 0, 0); the shares merge by
    the reference's pmax / psum rule: m = max m_s, l = sum exp(m_s - m) l_s,
    o = sum exp(m_s - m) o_s / max(l, 1e-30)."""
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    n_tiles = -(-tk // block_k)
    hi = min(-(-(q_offset + tq) // block_k), n_tiles) if causal else n_tiles
    lo = max((q_offset - window + 1) // block_k, 0) if window is not None else 0
    n_vis = max(hi - lo, 0)
    qf = q.float().reshape(b, hkv, hq // hkv, tq, dh) * dh**-0.5
    pad = n_tiles * block_k - tk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))[:, :, None]
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))[:, :, None]
    qpos = torch.arange(tq)[:, None] + q_offset
    ms, ls, os_ = [], [], []
    for s in range(n_split):
        s_lo, s_hi = lo + n_vis * s // n_split, lo + n_vis * (s + 1) // n_split
        if s_hi <= s_lo:
            ms.append(torch.full((b, hkv, hq // hkv, tq, 1), -math.inf))
            ls.append(torch.zeros(b, hkv, hq // hkv, tq, 1))
            os_.append(torch.zeros_like(qf))
            continue
        keys = slice(s_lo * block_k, s_hi * block_k)
        kpos = torch.arange(keys.start, keys.stop)[None, :]
        keep = kpos < tk
        if causal:
            keep = keep & (kpos <= qpos)
        if window is not None:
            keep = keep & (kpos > qpos - window)
        scores = (qf @ kf[..., keys, :].transpose(-1, -2)).masked_fill(~keep, -1e30)
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        os_.append(p @ vf[..., keys, :])
    m_all = torch.stack(ms)
    m = m_all.amax(0)
    w = torch.where(m_all == -math.inf, 0.0, torch.exp(m_all - m))
    l = (w * torch.stack(ls)).sum(0)
    out = (w * torch.stack(os_)).sum(0) / l.clamp_min(1e-30)
    return out.reshape(b, hq, tq, dh).to(q.dtype)


SPLIT_DECODE_CASES = [  # b, hq, hkv, tq, tk, dh, causal, window, q_offset, n_split
    (2, 8, 2, 1, 1024, 64, True, None, 1023, 1),
    (2, 8, 2, 1, 1024, 64, True, None, 1023, 2),
    (2, 8, 2, 1, 1024, 64, True, None, 1023, 7),
    (1, 4, 1, 1, 4096, 32, True, None, 4095, 64),
    (2, 8, 2, 1, 1000, 32, True, None, 999, 7),     # Tk not a multiple of 64
    (1, 8, 2, 1, 2048, 32, True, 40, 2047, 7),      # a window narrower than a tile
    (1, 8, 2, 2, 2048, 32, True, 700, 1500, 7),     # a window across split boundaries
    (1, 8, 2, 1, 4096, 32, True, None, 100, 64),    # q_offset far below Tk: empty splits
    (1, 8, 2, 4, 1024, 32, True, None, 1500, 7),    # q_offset >= Tk
    (1, 8, 2, 1, 1024, 32, False, None, 0, 7),      # bidirectional
    (2, 8, 2, 1, 1, 32, True, None, 0, 2),          # Tk = 1: one share empty
    (1, 16, 1, 1, 2048, 64, True, None, 2047, 7),   # g * Tq = 16
    (1, 8, 2, 4, 2048, 32, True, 33, 2040, 2),      # g * Tq = 16 under a window
    (8, 16, 8, 1, 1024, 256, True, None, 8195, 1),  # gemma3's warm ring: every slot
    (2, 16, 8, 1, 1024, 256, True, None, 700, 2),   # a cold ring: the slots <= pos
    (2, 16, 16, 1, 2100, 80, True, None, 2099, 7),  # Dh 80
    (2, 64, 8, 1, 1024, 128, False, None, 0, 1),    # cross decode: g = 8, 1,024 image keys
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,causal,window,q_offset,n_split", SPLIT_DECODE_CASES)
def test_split_decode_arithmetic_matches_the_references(b, hq, hkv, tq, tk, dh, causal, window,
                                                        q_offset, n_split, dtype):
    """The model against ``attention_ref`` and the port's plain version: 2e-5
    in float32, both bf16 gates in bf16."""
    rng = np.random.default_rng(tk + n_split + q_offset)
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, b, hq, hkv, tq, tk, dh), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _split_decode_model(q, k, v, n_split=n_split, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in (attention_ref(jq, jk, jv, **kw), flash_attention_ref(q, k, v, **kw).float()):
        if dtype == "float32":
            _assert_close(got, want, TOL["float32"])
        else:
            _assert_bf16_gates(got, np.asarray(want, np.float32))


H100_SMS = 132
QWEN3_BLOCKS_PER_SM = 2  # the bf16, Dh = 128, g = 4 instance: a 96 KB ring, two blocks an SM


@pytest.mark.parametrize("batch,hkv,tk", [
    (8, 8, 160),        # the serve loop's cache: 3 tiles
    (1, 1, 1),
    (1, 8, 1984),       # 31 tiles: under two shares of 16
    (65536, 1, 32768),  # the grid-cap decode shape: B * Hkv fills the card
    (32, 8, 32768),     # 256 blocks: 0.97 of a round of two blocks on 132 SMs
])
def test_decode_splits_one_share(batch, hkv, tk):
    assert ops.decode_splits(batch, hkv, tk, H100_SMS, QWEN3_BLOCKS_PER_SM) == 1


@pytest.mark.parametrize("batch,blocks_per_sm,want", [
    (8, 2, 4), (16, 2, 2), (32, 2, 1), (2, 2, 16), (8, 1, 2)])
def test_decode_splits_fill_the_card_at_32k(batch, blocks_per_sm, want):
    """qwen3-8b (Hkv = 8) at a 32k cache: as many shares as one round of
    resident blocks on 132 SMs holds (B=8 at two blocks an SM: 4 shares, 256
    blocks of 264 slots; one block an SM, as the float32 Dh = 128 ring
    allows: 2), each share at least the tile floor."""
    n = ops.decode_splits(batch, 8, 32768, H100_SMS, blocks_per_sm)
    assert n == want
    slots = blocks_per_sm * H100_SMS
    assert batch * 8 * n <= slots < batch * 8 * (n + 1)
    assert 32768 // ops.TILE_KEYS // n >= ops.DECODE_MIN_TILES_PER_SPLIT


@pytest.mark.parametrize("sms", [1, 66, 132])
def test_decode_splits_never_exceed_the_tiles(sms):
    for blocks_per_sm in (1, 2, 4):
        for batch in (1, 2, 7, 64):
            for hkv in (1, 8):
                for tk in (1, 63, 64, 1000, 1024, 4095, 32768, 131072):
                    n = ops.decode_splits(batch, hkv, tk, sms, blocks_per_sm)
                    tiles = -(-tk // ops.TILE_KEYS)
                    assert 1 <= n <= tiles
                    assert n == 1 or tiles // n >= ops.DECODE_MIN_TILES_PER_SPLIT
                    assert n == 1 or batch * hkv * n <= sms * blocks_per_sm


# ------------------------------------------------------ the sliding-window ring
@pytest.mark.parametrize("dh", [32, 256])
@pytest.mark.parametrize("pos", [0, 5, 15, 16, 40, 1023])
def test_ring_decode_matches_the_reference_ring(pos, dh):
    """A decode step over a 16-slot ring (gemma3's local layers, reduced):
    the port's causal launch at ``q_offset = pos`` with no window against
    the reference's ring attention (``repro/models/model.py``'s
    ``_decode_gqa``: slot s counts if ``s <= pos or pos >= length``), and
    against the split decode model. Both sum the slots in slot order."""
    from repro_torch.models.attention import gqa_flash_decode

    b, hq, hkv, length = 2, 4, 2, 16
    rng = np.random.default_rng(pos * 10 + dh)
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, length, hkv, dh)).astype(np.float32) for _ in range(2))
    g = hq // hkv
    qg = jnp.asarray(q).reshape(b, hkv, g, dh) * dh**-0.5
    scores = jnp.einsum("bhgd,bshd->bhgs", qg, jnp.asarray(k))
    slots = jnp.arange(length)
    scores = jnp.where(((slots <= pos) | (pos >= length))[None, None, None], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    want = jnp.einsum("bhgs,bshd->bhgd", probs, jnp.asarray(v)).reshape(b, hq, dh)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = gqa_flash_decode(tq, tk, tv, pos, None)
    _assert_close(got, want, TOL["float32"])
    model = _split_decode_model(tq[:, :, None], tk.transpose(1, 2), tv.transpose(1, 2),
                                causal=True, q_offset=pos)
    _assert_close(model[:, :, 0], want, TOL["float32"])
