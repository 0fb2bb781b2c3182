"""Fused neighbour-partition histogram + FENNEL penalty (Eq. 7)."""
