"""Plain PyTorch version of the attention kernel.

Exact softmax attention in float32 with causal, sliding-window and
``q_offset`` masks, GQA by reshaping the query heads into groups of their
key/value head (no repeat of K/V). The value may be narrower than the query
and key (MLA: Dv < Dqk); the scores are scaled by ``Dqk ** -0.5``, as the
reference's ``_sdpa`` scales by its query's width. Masked scores take the finite ``-1e30``,
as the kernel and the reference's model code (``_sdpa``) do. The wrapper in
``ops.py`` takes this for CPU tensors; the tests and ``chip_smoke.py`` hold
the kernel against it.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def flash_attention_ref(
    q: torch.Tensor,  # [B, Hq, Tq, Dqk]
    k: torch.Tensor,  # [B, Hkv, Tk, Dqk]
    v: torch.Tensor,  # [B, Hkv, Tk, Dv]
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``[B, Hq, Tq, Dv]`` in ``q``'s dtype; query row ``i`` sits at absolute
    position ``q_offset + i``."""
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = (q.float() * dh**-0.5).reshape(b, hkv, g, tq, dh)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, tq, v.shape[-1]).to(q.dtype)
