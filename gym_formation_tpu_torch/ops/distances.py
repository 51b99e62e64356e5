"""Batched geometric primitives shared by scenarios and policies.

Distances use direct coordinate differences, never the Gram form
``|a|² + |b|² − 2a·b``, which loses about three digits to cancellation near
contact.
"""

from __future__ import annotations

import torch


def pairwise_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix between point sets in the plane a [..., N, 2]
    and b [..., M, 2] → [..., N, M].  By ``torch.hypot``, not ``torch.sqrt``,
    whose CPU kernel calls MKL's vector math library: see
    ``ops/kernels/pairforce.py: collision_forces_batched_plain``."""
    delta = a[..., :, None, :] - b[..., None, :, :]
    return torch.hypot(delta[..., 0], delta[..., 1])


def hausdorff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric Hausdorff distance ``max(directed(a,b), directed(b,a))``
    with ``directed(u,v) = max_i min_j |u_i − v_j|``.  [..., N, P] → [...]."""
    d = pairwise_dists(a, b)
    return torch.maximum(d.amin(-1).amax(-1), d.amin(-2).amax(-1))


def center(points: torch.Tensor) -> torch.Tensor:
    """Subtract the centroid over the second-to-last axis."""
    return points - points.mean(-2, keepdim=True)


def block_means(points: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Mean over contiguous equal blocks: [..., N, P] → [..., n_blocks, P]."""
    *lead, n, p = points.shape
    return points.reshape(*lead, n_blocks, n // n_blocks, p).mean(-2)
