"""Train, eval and serving step factories (port of ``repro.train.step``).

Loss = token cross-entropy (float32 ``log_softmax`` over the vocabulary)
plus ``router_aux_weight`` times the router aux loss (the MoE layers' summed
Switch loss; zero in a model without them). One microbatch per
step by default; with ``accum > 1`` the batch leaves carry a leading
``accum`` axis and the gradients of the microbatches are summed in float32
and divided, as the reference's ``lax.scan`` branch does (its ``ce`` is the
mean loss and its ``aux`` zero). Gradients come from ``torch.autograd``
through the model's forward, the attention and scan kernels included (their
wrappers carry the plain versions' gradients).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWState, adamw_update
from repro_torch.train.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.train.schedule import cosine_schedule

__all__ = ["make_decode_step", "make_eval_step", "make_loss_fn", "make_prefill_step",
           "make_train_step", "token_ce"]


def token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)
    return nll.mean()


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        ce = token_ce(logits, batch["labels"])
        loss = ce + model.cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """``(loss, metrics, grads)``: the gradient of every parameter leaf
    (zeros where the loss does not reach one), in the parameters' dtypes."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(tree_unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(treedef, grads)


def make_train_step(
    model: Model,
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    weight_decay: float = 0.1,
    accum: int = 1,
):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``lr`` (scalar tensors on the device); the returned parameters hold no
    autograd graph."""
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state: AdamWState, batch):
        if accum == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            # microbatch accumulation: batch leaves have a leading accum axis
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=opt_state.step.device)
            for i in range(accum):
                l, _, g = _value_and_grad(loss_fn, params, {k: v[i] for k, v in batch.items()})
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {"ce": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                      device=loss.device)}
        lr = cosine_schedule(opt_state.step, peak_lr, warmup, total_steps)
        new_params, new_opt, gnorm = adamw_update(
            grads, opt_state, params, lr, weight_decay=weight_decay
        )
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)

    return eval_step


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
