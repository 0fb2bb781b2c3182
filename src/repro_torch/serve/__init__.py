"""Serving layer (port of ``repro.serve``) - two subsystems under one
namespace:

* :mod:`repro_torch.serve.graph` - partition-aware graph query serving
  (router, boundary replication, load generator, tail-latency metrics);
* :mod:`repro_torch.serve.lm` - the LM prefill/decode steps and the
  flash-decode attention (``launch/serve.py`` runs the serve loop).

The LM names also resolve from this package root, lazily, so importing
graph serving never loads the model code.
"""
import importlib

_LM_EXPORTS = (
    "make_prefill_step",
    "make_decode_step",
    "gqa_flash_decode",
)
_SUBMODULES = ("graph", "lm")

__all__ = [*_LM_EXPORTS, *_SUBMODULES]


def __getattr__(name):  # PEP 562: lazy root re-exports
    if name in _LM_EXPORTS:
        from repro_torch.serve import lm

        return getattr(lm, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.serve.{name}")
    raise AttributeError(f"module 'repro_torch.serve' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
