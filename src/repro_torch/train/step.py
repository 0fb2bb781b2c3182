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

On a mesh (a ``Model`` with ``mesh``) the parameters and moments are
DTensors and the batch leaves DTensors split over the data axes
(``launch.specs.batch_specs``). Each rank's loss is its rows' mean over the
number of batch shards, so the shards' losses sum to the global batch's
mean; the gathered weights' gradients are summed over the batch shards
(``Partial`` on those axes) and land as the parameters' shards; the metrics
are all-reduced to the global values on every rank.

On a model axis above 1 the logits are this rank's vocabulary columns
where the specs split the head (``Model.forward``): the float32 cross-entropy
is then a vocabulary-parallel log-softmax (an all-reduced maximum and sum
of exponentials, and the label's logit from the rank that holds it), the
reference's value without gathering ``[B, T, V]``. Every rank of the model
axis gets the same loss, under ``activation_partitioning="seq"`` too (the
head reads the whole sequence), so the model axis is never among the
shards a loss or a metric is divided or summed over.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWState, adamw_update
from repro_torch.train.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.train.schedule import cosine_schedule

__all__ = ["make_decode_step", "make_eval_step", "make_loss_fn", "make_prefill_step",
           "make_train_step", "token_ce"]


def token_nll(logits: torch.Tensor, labels: torch.Tensor, vocab=None) -> torch.Tensor:
    """Each token's negative log-likelihood (float32 ``log_softmax``). Where
    ``vocab`` (a ``launch.mesh.ModelAxis``, ``Model.vocab_axis``) is split,
    the logits are this rank's columns of a vocabulary split over it: the
    log-sum-exp from the ranks' maxima and sums of exponentials, the label's
    logit from its owner (the sums all-reduced; their backward the
    identity, every rank's loss being the same)."""
    if vocab is None or not vocab.split:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.take_along_dim(logp, labels[..., None].long(), dim=-1)
    lf = logits.float()
    n = lf.shape[-1]
    m = vocab.max(lf.amax(-1, keepdim=True))
    lse = m + torch.log(vocab.sum(torch.exp(lf - m).sum(-1, keepdim=True)))
    local = labels[..., None].long() - vocab.rank * n
    own = (local >= 0) & (local < n)
    picked = torch.take_along_dim(lf, local.clamp(0, n - 1), dim=-1).masked_fill(~own, 0)
    return lse - vocab.sum(picked)


def token_ce(logits: torch.Tensor, labels: torch.Tensor, vocab=None) -> torch.Tensor:
    return token_nll(logits, labels, vocab).mean()


def _local(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return t.to(device)


def _shard_count(mesh, dims) -> int:
    n = 1
    for i in dims:
        n *= mesh.size(i)
    return n


def _all_reduce(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The sum of ``t`` over the mesh dims ``dims`` (a plain tensor back)."""
    from torch.distributed import _functional_collectives as funcol

    device = t.device
    if mesh.device_type != device.type:
        t = t.to(mesh.device_type)
    for i in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, "sum", (mesh, i)))
    return t.to(device)


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        labels = _local(batch["labels"], logits.device)
        mesh, dims = model.batch_split(batch)
        n = _shard_count(mesh, dims) if mesh is not None else 1
        ce = token_ce(logits, labels, model.vocab_axis(params)) / n
        if mesh is not None:  # this rank's part of the global batch's mean
            aux = aux / n
        loss = ce + model.cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def _microbatch(batch: dict, i: int) -> dict:
    """Microbatch ``i`` of batch leaves with a leading ``accum`` axis; a
    DTensor leaf keeps its split of the batch rows (dim 1 becomes dim 0)."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.specs import contiguous_stride

    out = {}
    for k, v in batch.items():
        if isinstance(v, DTensor):
            places = [Shard(pl.dim - 1) if isinstance(pl, Shard) else pl for pl in v.placements]
            local = v.to_local()[i]
            out[k] = DTensor.from_local(local, v.device_mesh, places, run_check=False,
                                        shape=v.shape[1:],
                                        stride=contiguous_stride(v.shape[1:]))
        else:
            out[k] = v[i]
    return out


def _value_and_grad(loss_fn, params, batch, one_thread: bool = False):
    """``(loss, metrics, grads)``: the gradient of every parameter leaf
    (zeros where the loss does not reach one), in the parameters' dtypes.

    ``one_thread`` runs the backward on this thread alone (a host mesh's:
    gloo ranks sharing a card): the engine otherwise runs the card's nodes
    on its own worker thread and the host's here, so the order in which the
    gradients' host collectives become ready, and are issued, would depend
    on the two threads' timing and could differ between ranks (a collective
    mismatch). On one thread the order is the graph's, the same on every
    rank. A mesh of the card's own runs its nodes on one thread anyway."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(tree_unflatten(treedef, leaves), batch)
    with torch.autograd.set_multithreading_enabled(not one_thread):
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
    sample=None,
):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``lr`` (scalar tensors on the device); the returned parameters hold no
    autograd graph.

    ``sample`` is for counting, not training (the dry run's
    ``OpCounter.repeat``): with ``accum > 1`` the step runs only the first
    microbatch, inside ``sample(accum)``, and its values are that
    microbatch's divided by ``accum``."""
    loss_fn = make_loss_fn(model)
    # a host mesh: collectives on the host, the model's nodes on a card
    one_thread = model.mesh is not None and model.mesh.device_type != model.device.type

    def train_step(params, opt_state: AdamWState, batch):
        if accum == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch, one_thread)
        else:
            # microbatch accumulation: batch leaves have a leading accum axis
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=opt_state.step.device)
            for i in range(1 if sample else accum):
                with sample(accum) if sample else contextlib.nullcontext():
                    l, _, g = _value_and_grad(loss_fn, params, _microbatch(batch, i),
                                              one_thread)
                    grads = tree_map(torch.add, grads, g)
                    loss = loss + l.to(loss.device)
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {"ce": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                      device=loss.device)}
        mesh, dims = model.batch_split(batch, rows_dim=0 if accum == 1 else 1)
        if mesh is not None:  # the global batch's values on every rank
            loss = _all_reduce(loss, mesh, dims)
            metrics = {k: _all_reduce(v, mesh, dims) for k, v in metrics.items()}
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
    position ``[B, 1, V]`` (on a mesh, this rank's rows over the whole
    vocabulary)."""

    def prefill(params, batch):
        logits, _ = model.forward(params, batch)
        return model.whole_vocab(params, logits[:, -1:])

    return prefill


def make_decode_step(model: Model):
    def decode(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode
