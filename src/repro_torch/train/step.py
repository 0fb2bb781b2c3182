"""Serving step factories (port of ``repro.train.step``'s
``make_prefill_step`` and ``make_decode_step``). The training and eval steps
wait for the training slice (ROADMAP Queue 1 item 8b)."""
from __future__ import annotations

from repro_torch.models.model import Model


def make_prefill_step(model: Model):
    """Serving prefill: forward only, returns the logits of the last
    position ``[B, 1, V]``."""

    def prefill(params, batch):
        logits, _ = model.forward(params, batch)
        return logits[:, -1:]

    return prefill


def make_decode_step(model: Model):
    def decode(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode
