"""Device resolution for every entry point of the port.

The port runs on an NVIDIA card unless the caller asks for the CPU. There is
no silent fallback: asking for the card (explicitly or by default) on a
machine without one raises, so a CPU run is always a deliberate choice.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is requested and none is
    available, and ``ValueError`` for device types the port does not run on.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run the "
                "port's plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
