"""Fused Mamba-1 selective scan (port of ``repro.kernels.mamba_scan``).
Importing the package builds nothing: the kernel is compiled on its first
launch."""
from repro_torch.kernels.mamba_scan.ops import selective_scan

__all__ = ["selective_scan"]
