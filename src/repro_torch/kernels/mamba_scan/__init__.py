"""Fused Mamba-1 selective scan (port of ``repro.kernels.mamba_scan``)."""
