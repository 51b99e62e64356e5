"""`basic_formation_env`: MPE simple-spread style landmark coverage.

PyTorch counterpart of ``gym_formation_tpu/envs/basic_formation.py``.
"""

from __future__ import annotations

import torch

from .. import _device
from ..core.types import EnvState, make_world_cfg
from ..ops.distances import pairwise_dists
from .scenario import Scenario


class BasicFormationScenario(Scenario):
    """Cover the landmarks: reward = −Σ_l min_a dist(a, l) − 1 per
    collision, threshold s1+s2."""

    name = "basic_formation_env"

    def __init__(
        self, num_agents: int = 3, num_landmarks: int = 3, world_length: int = 50,
        dtype=_device.DTYPE,
    ):
        # agent size 0.1; landmarks of the default size, static, not colliding
        self.cfg = make_world_cfg(num_agents, num_landmarks, agent_size=0.1, world_length=world_length)
        self.dtype = dtype
        self.obs_dim = 4 + 2 * num_landmarks + 4 * (num_agents - 1)

    def reset(self, generator: torch.Generator, num_envs: int) -> EnvState:
        """Agents, then landmarks, uniform in [−1, 1]²."""
        apos = self._uniform(generator, (num_envs, self.n, 2))
        lpos = self._uniform(generator, (num_envs, self.cfg.n_landmarks, 2))
        state = self.zero_state(num_envs, generator.device)
        return state.replace(pos=torch.cat([apos, lpos], dim=1))

    def observe(self, state: EnvState) -> torch.Tensor:
        """[B, N, 4 + 2L + 4(N−1)]: [p_vel | p_pos | landmarks_rel(2L) |
        others_rel(2N−2) | comm(2N−2)]."""
        B = state.pos.shape[0]
        apos = self.agent_pos(state)
        lrel = (self.landmark_pos(state)[:, None] - apos[:, :, None]).reshape(B, self.n, -1)
        return torch.cat(
            [self.agent_vel(state), apos, lrel, self._others_rel(apos), self._others_comm(state)],
            dim=-1,
        )

    def reward(self, state: EnvState) -> torch.Tensor:
        d = pairwise_dists(self.agent_pos(state), self.landmark_pos(state))
        shared = -d.amin(-2).sum(-1)
        # the original counts every agent against every agent without
        # excluding self: self is always a collision (distance 0), so each
        # agent pays an extra −1
        per_agent = self._collision_matrix(state).sum(-1)
        return shared[:, None] - per_agent.to(self.dtype)
