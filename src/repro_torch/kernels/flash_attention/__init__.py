"""Online-softmax attention (port of ``repro.kernels.flash_attention``).
Importing the package builds nothing: the kernels are compiled on their
first launch."""
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
