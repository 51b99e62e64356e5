"""`formation_hd_partial_env` and `formation_hd_partial_range_env`:
Hausdorff formation under partial observability.

PyTorch counterparts of ``gym_formation_tpu/envs/formation_hd_partial.py``:
each agent sees only the next ``num_obs`` agents, ring-indexed by agent id,
or every other agent with relative positions clipped to ±``obs_range``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..core.types import EnvState, make_world_cfg
from ..ops.distances import center, hausdorff
from .scenario import Scenario


class _HausdorffPartialBase(Scenario):
    """Shared reward and reset: −Hausdorff(centred agents, centred
    landmarks) − 1 per agent-agent collision (self excluded), threshold
    s1+s2."""

    def _init_world(self, num_agents, num_landmarks, world_length, dtype):
        self.cfg = make_world_cfg(
            num_agents,
            num_landmarks,
            agent_size=0.04,
            landmark_size=0.02,
            world_length=world_length,
        )
        self.dtype = dtype

    def reset(self, generator: torch.Generator, num_envs: int) -> EnvState:
        """Agents, then landmarks, uniform in [−1, 1]²."""
        apos = self._uniform(generator, (num_envs, self.n, 2))
        lpos = self._uniform(generator, (num_envs, self.cfg.n_landmarks, 2))
        state = self.zero_state(num_envs, generator.device)
        return state.replace(pos=torch.cat([apos, lpos], dim=1))

    def reward(self, state: EnvState) -> torch.Tensor:
        apos = self.agent_pos(state)
        shared = -hausdorff(center(apos), center(self.landmark_pos(state)))
        eye = torch.eye(self.n, dtype=torch.bool, device=apos.device)
        coll = (self._collision_matrix(state) & ~eye).sum(-1)
        return shared[:, None] - coll.to(self.dtype)

    def _landmarks_abs(self, state: EnvState) -> torch.Tensor:
        B, L = state.pos.shape[0], self.cfg.n_landmarks
        return self.landmark_pos(state).reshape(B, 1, 2 * L).expand(B, self.n, 2 * L)


class FormationHDPartialScenario(_HausdorffPartialBase):
    name = "formation_hd_partial_env"

    def __init__(
        self,
        num_agents: int = 5,
        num_landmarks: int = 5,
        num_obs: int = 3,
        world_length: int = 25,
        dtype=_device.DTYPE,
    ):
        self._init_world(num_agents, num_landmarks, world_length, dtype)
        self.num_obs = num_obs
        self.obs_dim = 2 + 2 * self.cfg.n_landmarks + 2 * num_obs + 2 * (num_agents - 1)
        # static ring gather: agent i observes agents (i+1 .. i+num_obs) mod N
        self._ring = np.stack([np.arange(1, num_obs + 1) + i for i in range(num_agents)]) % num_agents

    def observe(self, state: EnvState) -> torch.Tensor:
        """[B, N, 2 + 2L + 2·num_obs + 2(N−1)]: [p_vel | landmarks_abs |
        ring-neighbours rel | comm (all others)]."""
        B = state.pos.shape[0]
        apos = self.agent_pos(state)
        ring = _device.const(self._ring, apos, torch.int64)
        ring_rel = (apos[:, ring] - apos[:, :, None]).reshape(B, self.n, -1)
        return torch.cat(
            [self.agent_vel(state), self._landmarks_abs(state), ring_rel, self._others_comm(state)],
            dim=-1,
        )


class FormationHDPartialRangeScenario(_HausdorffPartialBase):
    name = "formation_hd_partial_range_env"

    def __init__(
        self,
        num_agents: int = 4,
        num_landmarks: int = 4,
        obs_range: float = 0.7,
        world_length: int = 25,
        dtype=_device.DTYPE,
    ):
        self._init_world(num_agents, num_landmarks, world_length, dtype)
        self.obs_range = obs_range
        self.obs_dim = 2 + 2 * self.cfg.n_landmarks + 4 * (num_agents - 1)

    def observe(self, state: EnvState) -> torch.Tensor:
        """[B, N, 2 + 2L + 4(N−1)]: [p_vel | landmarks_abs |
        clip(others_rel, ±obs_range) | comm]."""
        rel = self._others_rel(self.agent_pos(state)).clamp(-self.obs_range, self.obs_range)
        return torch.cat(
            [self.agent_vel(state), self._landmarks_abs(state), rel, self._others_comm(state)],
            dim=-1,
        )
