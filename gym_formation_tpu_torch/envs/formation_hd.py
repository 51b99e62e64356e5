"""`formation_hd_env`: Hausdorff-distance formation control (primary workload).

PyTorch counterpart of ``gym_formation_tpu/envs/formation_hd.py``: agents
must mimic the shape (translation-invariant) of a landmark constellation
while tracking a shared target velocity and avoiding collisions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..core.types import EnvState, make_world_cfg
from ..ops.distances import center, hausdorff, pairwise_dists
from ..ops.kernels import reward_sym
from .scenario import Scenario

# Default per-layer triangle shapes for fractal target synthesis.
DEFAULT_LAYER_SHAPES = np.array(
    [
        [[0, -1], [0.5, 0], [0, 1]],
        [[0, 1.6], [-1, 0], [1, 0]],
        [[1.5, 0], [0, 0], [-1.5, 0]],
        [[0, 0.6], [1, 0], [-1, 0]],
    ],
    dtype=np.float64,
)


def generate_shape(layer: int, layer_shapes: np.ndarray = None, *, fix_recursion: bool = False):
    """Recursive fractal composition of per-layer target shapes.

    ``shape[l] = layer_shapes[l][i] + 0.45 * shape[l-1]`` for each of the
    per-layer points i.  Returns a nested ``[n, ..., n, 2]`` array; callers
    ``.reshape(-1, 2)``.

    By default custom ``layer_shapes`` apply only to the top layer, as in the
    original (its recursive call drops the argument); ``fix_recursion=True``
    propagates them to every layer.
    """
    shapes = DEFAULT_LAYER_SHAPES if layer_shapes is None else np.asarray(layer_shapes, np.float64)
    if layer >= shapes.shape[0]:
        raise ValueError("Layer shape is not enough!")
    base_chain = shapes if (fix_recursion or layer_shapes is None) else DEFAULT_LAYER_SHAPES
    shape = shapes[0] if layer == 0 else base_chain[0]
    for l in range(1, layer + 1):
        lvl = shapes if l == layer else base_chain
        shape = np.stack([lvl[l][i] + shape * 0.45 for i in range(lvl.shape[1])])
    return shape


class FormationHDScenario(Scenario):
    """Reward = −Hausdorff(centred agents, ideal shape) − ‖ideal_vel −
    mean_vel‖ − 1 per collision; the collision threshold is (s1+s2)/2."""

    name = "formation_hd_env"
    collision_factor = 0.5

    def __init__(self, num_agents: int = 3, episode_length: int = 100, dtype=_device.DTYPE):
        self.cfg = make_world_cfg(
            num_agents,
            num_agents,
            agent_size=0.03,
            landmark_size=0.01,
            world_length=episode_length,
        )
        self.dtype = dtype
        self.obs_dim = 6 * num_agents

    def reset(self, generator: torch.Generator, num_envs: int) -> EnvState:
        """Draw order as the original: agent positions, landmark positions
        (which double as the ideal shape before centring), then the shared
        ideal velocity."""
        n = self.n
        apos = self._uniform(generator, (num_envs, n, 2))
        lpos = self._uniform(generator, (num_envs, n, 2))
        ivel = self._uniform(generator, (num_envs, 2))
        state = self.zero_state(num_envs, generator.device)
        return state.replace(
            pos=torch.cat([apos, lpos], dim=1),
            ideal_shape=lpos - lpos.mean(1, keepdim=True),
            ideal_vel=ivel,
        )

    def pre_obs(self, state: EnvState) -> EnvState:
        """Recentre the landmarks onto the agents' centroid.  Idempotent
        within a step."""
        apos, lpos = self.agent_pos(state), self.landmark_pos(state)
        delta = apos.mean(1, keepdim=True) - lpos.mean(1, keepdim=True)
        return state.replace(pos=torch.cat([apos, lpos + delta], dim=1))

    def observe(self, state: EnvState) -> torch.Tensor:
        """[B, N, 6N]: [p_vel(2) | others_rel(2N−2) | comm(2N−2) |
        ideal_shape(2N) | ideal_vel(2)]."""
        B, n = state.pos.shape[0], self.n
        flat_shape = state.ideal_shape.reshape(B, 1, 2 * n).expand(B, n, 2 * n)
        ivel = state.ideal_vel[:, None, :].expand(B, n, 2)
        return torch.cat(
            [
                self.agent_vel(state),
                self._others_rel(self.agent_pos(state)),
                self._others_comm(state),
                flat_shape,
                ivel,
            ],
            dim=-1,
        )

    def reward(self, state: EnvState) -> torch.Tensor:
        """Per-agent individual rewards [B, N]."""
        haus, ncoll = self._hd_stats(self.agent_pos(state), state.ideal_shape)
        dv = state.ideal_vel - self.agent_vel(state).mean(1)
        vel_term = -torch.sqrt((dv * dv).sum(-1))
        shared = -haus + vel_term
        return shared[:, None] - ncoll.to(self.dtype)

    # -- reward statistics --------------------------------------------------
    def _hd_stats_plain(self, apos: torch.Tensor, ishape: torch.Tensor):
        """(hausdorff [B], per-agent collision count [B, N]) by the plain
        formulas, for any agent sizes."""
        haus = hausdorff(center(apos), ishape)
        d = pairwise_dists(apos, apos)
        s = _device.const(self.cfg.size[: self.n], d)
        thresh = (s[:, None] + s[None, :]) * self.collision_factor
        eye = torch.eye(self.n, dtype=torch.bool, device=apos.device)
        ncoll = ((d < thresh) & ~eye).sum(-1)
        return haus, ncoll.to(apos.dtype)

    def _hd_stats(self, apos: torch.Tensor, ishape: torch.Tensor):
        """Uniform agent sizes go to kernel K2 (its plain version on the
        CPU).  Mixed sizes have no kernel in either package and run the
        plain formulas, as the JAX package does on a TPU."""
        size = self.cfg.size[: self.n]
        if not bool((size == size[0]).all()):
            return self._hd_stats_plain(apos, ishape)
        thresh = float(2.0 * size[0] * self.collision_factor)
        return reward_sym.hd_reward_stats_sym(
            apos.contiguous(), ishape.contiguous(), thresh=thresh
        )
