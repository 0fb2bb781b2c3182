"""LM serving: the prefill and decode steps and one-card flash-decode
attention. The implementations live in their natural homes
(:mod:`repro_torch.train.step`, :mod:`repro_torch.models.attention`; see
``launch/serve.py`` for the serve loop); this module is the public LM-serving
namespace, as ``repro.serve.lm`` is."""
from repro_torch.models.attention import gqa_flash_decode, mla_flash_decode
from repro_torch.train.step import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step", "gqa_flash_decode", "mla_flash_decode"]
