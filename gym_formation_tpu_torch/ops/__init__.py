from .distances import block_means, center, hausdorff, pairwise_dists

__all__ = ["block_means", "center", "hausdorff", "pairwise_dists"]
