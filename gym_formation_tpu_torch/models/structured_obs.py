"""Factorized first layers for the hd observation: the obs-free MAPPO path.

Counterpart of ``gym_formation_tpu/models/structured_obs.py``.  The
formation_hd observation is a linear repackaging of O(N) state
(``envs/formation_hd.py:observe``)::

    obs_i = [vel_i (2) | p_k - p_i for k != i (2N-2) | comm = 0 (2N-2) |
             flat ideal_shape (2N) | ideal_vel (2)]

so the first Dense layer's product ``obs_i @ W`` never needs the 6N-wide
observation.  With ``W~[j] = W[2+2j : 4+2j]`` the slot blocks of the relative
positions, the neighbour k of agent i sits in slot ``k - (k > i)``, and

    sum_{k != i} (p_k - p_i) @ W~[slot]
      = TOT + sum_{k < i} (p_k - p_{k+1}) @ W~[k] - p_i @ U

with ``TOT = sum_j p_{j+1} @ W~[j]`` and ``U = sum_j W~[j]``.  For the
centralized critic the cross terms collapse into parameter-only sums
(:func:`_critic_vu`).  At N=243 this removes the [T·B, N, 6N] observation
from the trajectory and most of the first layers' work.

Weights are taken ``[in, out]`` (``nn.Linear.weight.T``), as flax stores
them, so the algebra reads as the JAX package's.  The functions take the
port's modules (:class:`~.networks.GaussianActor`,
:class:`~.networks.ValueCritic`) and are differentiable by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from .networks import GaussianActor, ValueCritic


def _split_actor_w(W: torch.Tensor, n: int):
    """Rows of the first Dense kernel [6N, H] by observation block (the comm
    rows dropped: silent agents make that block identically zero)."""
    Wv = W[0:2]
    Wr = W[2 : 2 * n].reshape(n - 1, 2, -1)  # slot blocks W~[j]
    Ws = W[4 * n - 2 : 6 * n - 2]
    Wi = W[6 * n - 2 : 6 * n]
    return Wv, Wr, Ws, Wi


def hd_actor_h1(W, b, apos, avel, ishape, ivel, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``obs @ W + b`` for every agent without building obs.

    apos/avel/ishape: [..., N, 2]; ivel: [..., 2]; W [6N, H], b [H].  Returns
    [..., N, H].  ``dtype=torch.bfloat16`` runs the block products in bf16
    and returns h1 in bf16 (``MAPPOConfig.structured_bf16``).

    The prefix sum ``sum_{k<i} (p_k - p_{k+1}) @ W~[k]`` is a cumulative sum
    over agents.  The JAX package spells it as a product with a strictly
    lower-triangular [N, N-1] matrix, because a cumulative sum is a
    sequential scan on a TPU; on the GPU the cumulative sum is linear in N
    where the triangle is quadratic (96 G multiply-adds an epoch at N=243,
    B=1024 in the forward alone).  The sum is accumulated in at least
    float32.
    """
    n = apos.shape[-2]
    if dtype is not None:
        W, b, apos, avel, ishape, ivel = (x.to(dtype) for x in (W, b, apos, avel, ishape, ivel))
    Wv, Wr, Ws, Wi = _split_actor_w(W, n)
    diff = apos[..., : n - 1, :] - apos[..., 1:, :]
    d = torch.einsum("...kc,kch->...kh", diff, Wr)  # (p_k - p_{k+1}) @ W~[k]
    tot = torch.einsum("...kc,kch->...h", apos[..., 1:, :], Wr)  # TOT
    acc = torch.promote_types(d.dtype, torch.float32)
    prefix = torch.cumsum(d, dim=-2, dtype=acc).to(d.dtype)  # sum_{k<=i}
    P = torch.cat([torch.zeros_like(prefix[..., :1, :]), prefix], dim=-2)  # sum_{k<i}
    U = Wr.sum(0)  # [2, H]
    shared = ishape.reshape(*ishape.shape[:-2], 2 * n) @ Ws + ivel @ Wi + b + tot
    return avel @ Wv + P - apos @ U + shared[..., None, :]


def _critic_vu(Wc: torch.Tensor, n: int):
    """Parameter-only sums for the critic's cross terms: (Wv_i [N, 2, H],
    U_i [N, 2, H], V_k [N, 2, H], Ws_sum [2N, H], Wi_sum [2, H]).  O(N²·H)
    once per forward, not per sample."""
    H = Wc.shape[-1]
    Wb = Wc.reshape(n, 6 * n, H)
    Wv_i = Wb[:, 0:2]
    Wr_i = Wb[:, 2 : 2 * n].reshape(n, n - 1, 2, H)  # A_i[j] = W~_i[j]
    Ws_sum = Wb[:, 4 * n - 2 : 6 * n - 2].sum(0)
    Wi_sum = Wb[:, 6 * n - 2 : 6 * n].sum(0)
    U_i = Wr_i.sum(1)
    # V_k = sum_{i>k} A_i[k] + sum_{i<k} A_i[k-1]
    i_idx = torch.arange(n, device=Wc.device)[:, None]
    j_idx = torch.arange(n - 1, device=Wc.device)[None, :]
    C1 = torch.einsum("ijch,ij->jch", Wr_i, (i_idx > j_idx).to(Wc.dtype))  # sum_{i>j} A_i[j]
    C2p = torch.einsum("ijch,ij->jch", Wr_i, (i_idx <= j_idx).to(Wc.dtype))  # sum_{i<=j} A_i[j]
    z = torch.zeros_like(C1[:1])
    V = torch.cat([C1, z], 0) + torch.cat([z, C2p], 0)
    return Wv_i, U_i, V, Ws_sum, Wi_sum


def hd_critic_h1(Wc, bc, apos, avel, ishape, ivel) -> torch.Tensor:
    """``share_obs @ Wc + bc`` without building share_obs.  [..., H]."""
    n = apos.shape[-2]
    Wv_i, U_i, V_k, Ws_sum, Wi_sum = _critic_vu(Wc, n)
    flat = lambda a: a.reshape(*a.shape[:-2], 2 * n)
    per_agent = lambda a, w: flat(a) @ w.reshape(2 * n, -1)
    return (
        per_agent(avel, Wv_i)
        + per_agent(apos, V_k)
        - per_agent(apos, U_i)
        + flat(ishape) @ Ws_sum
        + ivel @ Wi_sum
        + bc
    )


def _mlp_tail(layers, h1pre: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The rest of the MLP trunk given the first layer's pre-activation
    (``networks.MLP``: Dense then relu per layer)."""
    h = torch.relu(h1pre)
    for lin in layers[1:]:
        w, b = lin.weight, lin.bias
        if dtype is not None:
            w, b = w.to(dtype), b.to(dtype)
        h = torch.relu(h @ w.T + b)
    return h


def actor_forward_structured(actor: GaussianActor, apos, avel, ishape, ivel,
                             dtype: Optional[torch.dtype] = None):
    """``actor(obs)`` on the hd observation, from the state parts.  With
    ``dtype`` set the trunk and head run in that type; the distribution
    parameters come back in the actor's own type either way."""
    first = actor.mlp.layers[0]
    h1 = hd_actor_h1(first.weight.T, first.bias, apos, avel, ishape, ivel, dtype=dtype)
    h = _mlp_tail(actor.mlp.layers, h1, dtype=dtype)
    wh, bh = actor.head.weight, actor.head.bias
    if dtype is not None:
        wh, bh = wh.to(dtype), bh.to(dtype)
    mean = (h @ wh.T + bh).to(actor.log_std.dtype)
    return mean, actor.bounded_log_std().expand_as(mean)


def critic_forward_structured(critic: ValueCritic, apos, avel, ishape, ivel) -> torch.Tensor:
    """``critic(share_obs)`` on the hd observation, from the state parts."""
    first = critic.mlp.layers[0]
    h1 = hd_critic_h1(first.weight.T, first.bias, apos, avel, ishape, ivel)
    h = _mlp_tail(critic.mlp.layers, h1)
    return critic.head(h).squeeze(-1)
