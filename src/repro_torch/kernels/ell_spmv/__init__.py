"""Sparse gather/reduce of the analytics engine (port of ``repro.kernels.ell_spmv``).
Importing the package builds nothing: the kernel is compiled on its first
launch."""
from repro_torch.kernels.ell_spmv.ops import ell_spmv

__all__ = ["ell_spmv"]
