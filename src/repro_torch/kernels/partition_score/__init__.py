"""Fused neighbour-partition histogram + FENNEL penalty (Eq. 7). Importing
the package builds nothing: the kernel is compiled on its first launch."""
from repro_torch.kernels.partition_score.ops import fennel_scores, fennel_scores_sharded

__all__ = ["fennel_scores", "fennel_scores_sharded"]
