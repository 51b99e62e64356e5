"""MATD3: multi-agent TD3 on the MADDPG chassis.

Counterpart of ``gym_formation_tpu/algos/matd3.py``: twin per-agent critics
whose minimum makes the target, target-policy smoothing (clipped Gaussian
noise on the target actors' next actions; on a discrete env a
straight-through Gumbel-softmax sample of the target logits), and delayed
actor updates: the critics train every update, the actors and both targets
on every ``policy_delay``-th, counted before the update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..env import FormationEnv
from ..models.networks import StackedTwinQCritic, gumbel, gumbel_softmax_st, twin_q_critic_from_flax
from .maddpg import MADDPG, MADDPGConfig, MADDPGState


@dataclasses.dataclass(frozen=True)
class MATD3Config(MADDPGConfig):
    target_noise: float = 0.2
    target_noise_clip: float = 0.5
    policy_delay: int = 2


class MATD3(MADDPG):
    critic_cls = StackedTwinQCritic
    critic_from_flax = staticmethod(twin_q_critic_from_flax)

    def __init__(self, env: FormationEnv, cfg: MATD3Config = MATD3Config(), num_envs: int = 32,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(env, cfg, num_envs, device, dtype)

    def _update_draws(self, generator: torch.Generator, M: int) -> Dict[str, torch.Tensor]:
        """MADDPG's, and the target smoothing's: normals [M, N, da], or the
        Gumbel noise of the target sample (discrete)."""
        draws = super()._update_draws(generator, M)
        shape = (M, self.n_agents, self.act_dim)
        if self.discrete:
            draws["target_gumbel"] = gumbel(generator, shape, self.dtype, self.device)
        else:
            draws["target_noise"] = torch.randn(shape, generator=generator, dtype=self.dtype, device=self.device)
        return draws

    def _target_actions(self, ts: MADDPGState, batch, draws):
        cfg = self.cfg
        u_next = ts.target_actor(batch["next_obs"])
        if self.discrete:
            return gumbel_softmax_st(draws["target_gumbel"], u_next)
        noise = torch.clamp(cfg.target_noise * draws["target_noise"], -cfg.target_noise_clip, cfg.target_noise_clip)
        return torch.clamp(u_next + noise, -cfg.high_action, cfg.high_action)

    def _q_target(self, ts: MADDPGState, o, u):
        return torch.minimum(*ts.target_critic(o, u))

    def _critic_bellman_err(self, critic, o, u, target):
        q1, q2 = critic(o, u)
        return (target - q1) ** 2 + (target - q2) ** 2, (target - q1).abs()

    def _q_policy(self, critic, o, u):
        return critic(o, u)[0]

    def _actor_due(self, ts: MADDPGState) -> bool:
        return ts.grad_updates % self.cfg.policy_delay == 0
