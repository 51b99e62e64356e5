"""`formation_hd_obs_env`: Hausdorff formation among falling obstacles.

PyTorch counterpart of ``gym_formation_tpu/envs/formation_hd_obs.py``.  The
landmark block holds ``num_landmarks`` static targets followed by
``num_obstacles`` movable, colliding obstacles spawned in bands along the
top edge and driven downward by :meth:`post_step`.  The colliding subset
(agents of size 0.1, obstacles of size 0.15) mixes sizes, so its contact
forces take the dense pair kernel K6 under the default selector.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..core.types import EnvState, make_world_cfg
from ..ops.distances import center, hausdorff, pairwise_dists
from .scenario import Scenario


class FormationHDObsScenario(Scenario):
    name = "formation_hd_obs_env"

    def __init__(
        self,
        num_agents: int = 4,
        num_landmarks: int = 4,
        num_obstacles: int = 3,
        world_length: int = 50,
        dtype=_device.DTYPE,
    ):
        self.num_targets = num_landmarks
        self.num_obstacles = num_obstacles
        # agents size 0.1; targets size 0.02, static, not colliding;
        # obstacles size 0.15, colliding and movable
        self.cfg = make_world_cfg(
            num_agents,
            num_landmarks + num_obstacles,
            agent_size=0.1,
            landmark_size=np.array([0.02] * num_landmarks + [0.15] * num_obstacles),
            landmark_collide=np.array([False] * num_landmarks + [True] * num_obstacles),
            landmark_movable=np.array([False] * num_landmarks + [True] * num_obstacles),
            world_length=world_length,
        )
        self.dtype = dtype
        self.obs_dim = 2 + 2 * (num_landmarks + num_obstacles) + 4 * (num_agents - 1)
        band = np.linspace(-1.8, 1.8, num_obstacles + 1)
        self._band_lo = np.stack([band[:-1], np.full(num_obstacles, 2.0)], -1)
        self._band_hi = np.stack([band[1:], np.full(num_obstacles, 2.5)], -1)

    def reset(self, generator: torch.Generator, num_envs: int) -> EnvState:
        """Agents and targets uniform in [−1, 1]²; obstacle k uniform in its
        band [step_k, step_k+1] × [2.0, 2.5], with velocity (0, −1).  Draw
        order: agents, targets, obstacles."""
        n, t, o = self.n, self.num_targets, self.num_obstacles
        apos = self._uniform(generator, (num_envs, n, 2))
        tpos = self._uniform(generator, (num_envs, t, 2))
        u = torch.rand((num_envs, o, 2), generator=generator, device=generator.device, dtype=self.dtype)
        lo, hi = _device.const(self._band_lo, u), _device.const(self._band_hi, u)
        opos = lo + u * (hi - lo)
        state = self.zero_state(num_envs, generator.device)
        state.vel[:, n + t :, 1] = -1.0
        return state.replace(pos=torch.cat([apos, tpos, opos], dim=1))

    def observe(self, state: EnvState) -> torch.Tensor:
        """[B, N, 2 + 2(T+O) + 4(N−1)]: [p_vel | targets_abs | obstacles_rel |
        others_rel | comm]; targets are absolute, obstacles relative."""
        B, n, t = state.pos.shape[0], self.n, self.num_targets
        apos = self.agent_pos(state)
        targets = state.pos[:, n : n + t].reshape(B, 1, 2 * t).expand(B, n, 2 * t)
        obst_rel = (state.pos[:, None, n + t :] - apos[:, :, None]).reshape(B, n, -1)
        return torch.cat(
            [self.agent_vel(state), targets, obst_rel, self._others_rel(apos), self._others_comm(state)],
            dim=-1,
        )

    def reward(self, state: EnvState) -> torch.Tensor:
        """−Hausdorff(centred agents, centred targets) − 2 per agent-agent
        collision (self excluded) − 2 per agent-obstacle collision, with
        the threshold s1+s2.  [B, N]."""
        n, t = self.n, self.num_targets
        apos = self.agent_pos(state)
        shared = -hausdorff(center(apos), center(state.pos[:, n : n + t]))
        eye = torch.eye(n, dtype=torch.bool, device=apos.device)
        coll_aa = (self._collision_matrix(state) & ~eye).sum(-1)
        d_ao = pairwise_dists(apos, state.pos[:, n + t :])
        s_a = _device.const(self.cfg.size[:n], d_ao)
        s_o = _device.const(self.cfg.size[n + t :], d_ao)
        coll_ao = (d_ao < (s_a[:, None] + s_o[None, :])).sum(-1)
        return shared[:, None] - 2.0 * (coll_aa + coll_ao).to(self.dtype)

    def post_step(self, state: EnvState) -> EnvState:
        """Obstacle driving law: velocity (0, −1) while y > −2.2, else 0."""
        n, t = self.n, self.num_targets
        falling = state.pos[:, n + t :, 1] > -2.2
        zero = torch.zeros_like(state.pos[:, n + t :, 1])
        ovel = torch.stack([zero, torch.where(falling, -1.0, zero)], -1)
        return state.replace(vel=torch.cat([state.vel[:, : n + t], ovel], dim=1))
