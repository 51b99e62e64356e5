"""Prioritized experience replay on the learner's device.

Counterpart of ``gym_formation_tpu/algos/per.py``: the priorities are one
vector beside the ring, a new transition gets the running maximum, and a
batch is drawn with probability ``P(i) = p_i^α / Σ p^α`` over the filled
slots, with importance weights ``(n · P(i))^(−β)`` normalized by the batch's
largest.

The JAX package draws the batch with ``jax.random.categorical``, a
Gumbel-max over every slot, which makes ``[batch, cap]`` noise (256 ×
500,000 floats an update at the default sizes).  Here the same distribution
is drawn by the inverse CDF: one cumulative sum of ``p^α`` in float64 and a
binary search for each of the batch's uniforms.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .maddpg import ReplayBuffer


class PrioritizedReplayBuffer(ReplayBuffer):
    """:class:`ReplayBuffer` with ``priority`` [cap] (raw |TD| + eps) and
    ``max_priority``, a 0-dim tensor on the device."""

    _tensors = ReplayBuffer._tensors + ("priority", "max_priority")

    def __init__(self, cap: int, n_agents: int, obs_dim: int, act_dim: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cap, n_agents, obs_dim, act_dim, device, dtype)
        self.priority = torch.zeros(cap, dtype=dtype, device=device)
        self.max_priority = torch.ones((), dtype=dtype, device=device)

    def insert(self, obs, action, reward, next_obs, done) -> None:
        self._ring_write(self.priority, self.max_priority.expand(obs.shape[0]))
        super().insert(obs, action, reward, next_obs, done)

    def weights(self, idx: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
        """The importance weights of the slots ``idx``: ``(n·P(i))^(−β)``
        over the filled prefix of n slots, divided by their largest."""
        logits = alpha * torch.log(self.priority[:self.size].clamp_min(1e-12))
        logp = logits[idx] - torch.logsumexp(logits, 0)
        w = torch.exp(-beta * (math.log(max(self.size, 1)) + logp))
        return w / w.max()

    def sample_prioritized(self, generator: torch.Generator, batch_size: int, alpha: float,
                           beta: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """``batch_size`` slots drawn ∝ ``p^α`` with replacement: returns
        ``(batch, idx, weights)``."""
        p = self.priority[:self.size].double().clamp_min(1e-12) ** alpha
        cdf = torch.cumsum(p, 0)
        u = torch.rand(batch_size, generator=generator, dtype=torch.float64, device=cdf.device) * cdf[-1]
        idx = torch.searchsorted(cdf, u, right=True).clamp_max(self.size - 1)
        return self.gather(idx), idx, self.weights(idx, alpha, beta)

    def update_priorities(self, idx: torch.Tensor, td_abs: torch.Tensor, eps: float = 1e-6) -> None:
        """Priority ``|TD| + eps`` at ``idx``; the running maximum follows.
        Of repeated indices, which write lands is not defined."""
        p = (td_abs + eps).to(self.priority.dtype)
        self.priority[idx] = p
        self.max_priority = torch.maximum(self.max_priority, p.max())


def beta_schedule(step: int, beta0: float = 0.4, anneal_steps: int = 100_000) -> float:
    """Linear β anneal from ``beta0`` to 1 over ``anneal_steps`` env steps."""
    frac = min(max(step / anneal_steps, 0.0), 1.0)
    return beta0 + (1.0 - beta0) * frac
