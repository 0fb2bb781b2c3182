"""Sparse gather/reduce of the analytics engine (port of ``repro.kernels.ell_spmv``)."""
