"""The mesh tests' rule for parameters after a few AdamW steps, and the
float64 one-device run it reads.

A mesh run adds float32 sums in another order than one device: a data axis
sums the gradient over the batch shards, a model axis adds the ranks'
partial products. Most parameters then agree with the one-device float32
run within 1e-5 relative L2. A gradient entry that is a sum of terms which
cancel keeps only a few correct bits in float32, and AdamW divides it by
its own root-mean-square, so its step can differ by a large part of the
learning rate between two float32 runs (observed: reduced jamba's first
Mamba ``conv_b``, zero at init, 40 of 512 entries; the tensor 3.0e-5 off).
Such an entry is one that float32 does not resolve: there the one-device
float32 run itself misses a float64 run of the same program from the same
parameters. Those entries are held within twice the summed learning rates
(each run moves an entry by about the learning rate a step at most, the
bound ``tests/test_torch_seq_parallel.py`` holds Adam's eps-regime entries
to); the rest of the tensor at the tolerance.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def float64_program():
    """A float64 run of the port's float32 program on the CPU: ``.float()``
    (the float32 computations of the models, the loss and AdamW) leaves a
    float64 tensor as it is, the scan takes its plain version on float64
    inputs, and ``Model.init`` of a float64 config draws the float32
    config's parameters and converts them, so the run starts where the
    float32 one does."""
    import repro_torch.models.mamba as mamba_mod
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    from repro_torch.models.model import Model

    to_float, scan, init = torch.Tensor.float, mamba_mod.selective_scan, Model.init

    def as_float(t, *args, **kwargs):
        return t if t.dtype == torch.float64 else to_float(t, *args, **kwargs)

    def any_scan(x, *args, **kwargs):
        fn = selective_scan_ref if x.dtype == torch.float64 else scan
        return fn(x, *args, **kwargs)

    def init64(self, gen):
        if self.dtype != torch.float64:
            return init(self, gen)
        from repro_torch.train.pytree import tree_map

        m32 = Model(dataclasses.replace(self.cfg, dtype="float32"), self.device)
        return tree_map(lambda t: t.double() if t.is_floating_point() else t, init(m32, gen))

    torch.Tensor.float, mamba_mod.selective_scan, Model.init = as_float, any_scan, init64
    try:
        yield
    finally:
        torch.Tensor.float, mamba_mod.selective_scan, Model.init = to_float, scan, init


def unresolved(want: torch.Tensor, want64: torch.Tensor, rtol: float) -> torch.Tensor:
    """The entries of the one-device float32 parameter ``want`` that miss
    the float64 run's ``want64`` by more than ``rtol`` of its
    root-mean-square: float32 does not resolve them."""
    want, want64 = want.double(), want64.double()
    rms = float(want64.norm()) / max(want64.numel(), 1) ** 0.5
    return (want - want64).abs() > rtol * rms


def assert_param_close(got: torch.Tensor, want: torch.Tensor, want64: torch.Tensor,
                       lr_sum: float, rtol: float, what, strict=None) -> None:
    """The mesh run's parameter ``got`` against the one-device float32
    run's ``want`` (the module's rule): the entries float32 does not
    resolve (against ``want64``) within ``2 * lr_sum``, the rest (within
    ``strict``, where given) at ``rtol`` relative L2."""
    got, want = got.double(), want.double()
    assert got.shape == want.shape, what
    loose = unresolved(want, want64, rtol)
    assert bool(((got - want)[loose].abs() <= 2 * lr_sum).all()), (what, "unresolved entries")
    keep = ~loose if strict is None else strict & ~loose
    err = float((got - want)[keep].norm())
    assert err <= rtol * max(float(want[keep].norm()), 1e-12), (what, err)
