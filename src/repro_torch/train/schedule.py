"""LR schedules (port of ``repro.train.schedule``)."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor_frac * peak_lr`` at ``total``; float32, on ``step``'s
    device (``step`` a tensor or an int)."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
