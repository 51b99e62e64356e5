"""Scenario protocol: batched workload definitions.

PyTorch counterpart of ``gym_formation_tpu/envs/scenario.py``.  A scenario
is a small class of functions over a batched
:class:`~gym_formation_tpu_torch.core.types.EnvState` (leading env axis B)
plus a static :class:`~gym_formation_tpu_torch.core.types.WorldCfg`.
Side effects of the original environment's callbacks are explicit
``pre_obs`` / ``post_step`` phases.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import _device
from ..core.types import EnvState, WorldCfg
from ..ops.distances import pairwise_dists


def _drop_diag(x: torch.Tensor) -> torch.Tensor:
    """[B, n, n, d] → [B, n, n−1, d]: row i keeps its entries j ≠ i in
    index order.  Reshapes only, no gather: after the flat (0, 0) entry
    is dropped, every other diagonal entry ends a row of length n + 1."""
    B, n, _, d = x.shape
    flat = x.reshape(B, n * n, d)[:, 1:]
    return flat.reshape(B, n - 1, n + 1, d)[:, :, :n].reshape(B, n, n - 1, d)


class Scenario:
    """Base scenario.  Subclasses set ``cfg`` and implement reset/observe/reward."""

    name: str = "base"
    cfg: WorldCfg
    obs_dim: int
    dtype = _device.DTYPE
    # Collision predicate threshold factor: (s1+s2)/2 in the hd scenario,
    # s1+s2 everywhere else.
    collision_factor: float = 1.0

    # -- helpers ------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.cfg.n_agents

    def agent_pos(self, state: EnvState) -> torch.Tensor:
        return state.pos[:, : self.cfg.n_agents]

    def agent_vel(self, state: EnvState) -> torch.Tensor:
        return state.vel[:, : self.cfg.n_agents]

    def landmark_pos(self, state: EnvState) -> torch.Tensor:
        return state.pos[:, self.cfg.n_agents :]

    def _collision_matrix(self, state: EnvState) -> torch.Tensor:
        """[B, N, N] bool: agents i, j closer than the threshold (the
        diagonal is True, as distance 0 passes the original predicate)."""
        apos = self.agent_pos(state)
        d = pairwise_dists(apos, apos)
        s = _device.const(self.cfg.size[: self.n], d)
        thresh = (s[:, None] + s[None, :]) * self.collision_factor
        return d < thresh

    def _uniform(self, generator: torch.Generator, shape) -> torch.Tensor:
        """U(−1, 1) draws on the generator's device."""
        u = torch.rand(shape, generator=generator, device=generator.device, dtype=self.dtype)
        return u * 2.0 - 1.0

    def _others_rel(self, pos_a: torch.Tensor) -> torch.Tensor:
        """[B, N, 2(N−1)] relative positions of every other agent, in agent
        order with self removed."""
        B, n, _ = pos_a.shape
        rel = pos_a[:, None, :, :] - pos_a[:, :, None, :]  # [B, self, other, 2]
        return _drop_diag(rel).reshape(B, n, 2 * (n - 1))

    def _others_comm(self, state: EnvState) -> torch.Tensor:
        """[B, N, (N−1)·dim_c] comm of the other agents, self removed."""
        B, n, dc = state.c.shape
        c = state.c[:, None].expand(B, n, n, dc)
        return _drop_diag(c).reshape(B, n, (n - 1) * dc)

    # -- protocol -----------------------------------------------------------
    def reset(self, generator: torch.Generator, num_envs: int) -> EnvState:
        raise NotImplementedError

    def pre_obs(self, state: EnvState) -> EnvState:
        """State adjustment made before the observation (default: none)."""
        return state

    def observe(self, state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    def reward(self, state: EnvState) -> torch.Tensor:
        """Per-agent individual rewards [B, N]."""
        raise NotImplementedError

    def post_step(self, state: EnvState) -> EnvState:
        """State adjustment made once after obs and reward (default: none)."""
        return state

    # Scripted agents: where ``scripted_mask`` (numpy [n_agents] bool) is
    # True, the env steps :meth:`scripted_actions` instead of the policy's
    # control.
    scripted_mask = None

    def scripted_actions(self, state: EnvState) -> torch.Tensor:
        """Control of the scripted agents [B, n_agents, dim_p]; rows where
        ``scripted_mask`` is False are ignored."""
        raise NotImplementedError

    def benchmark(self, state: EnvState) -> Dict[str, torch.Tensor]:
        """The reward/collisions/min_dists/occupied_landmarks quartet, each
        [B, N].  ``collisions`` counts self, as the original does."""
        rew = self.reward(state)
        collisions = self._collision_matrix(state).sum(-1)
        d = pairwise_dists(self.agent_pos(state), self.benchmark_landmarks(state))
        lmin = d.amin(-2)  # [B, L]
        return {
            "reward": rew,
            "collisions": collisions.to(rew.dtype),
            "min_dists": lmin.sum(-1, keepdim=True).expand_as(rew),
            "occupied_landmarks": (lmin < 0.1).sum(-1, keepdim=True).to(rew.dtype).expand_as(rew),
        }

    def benchmark_landmarks(self, state: EnvState) -> torch.Tensor:
        """Landmark set used by the benchmark min-dist stats."""
        return self.landmark_pos(state)

    def zero_state(self, num_envs: int, device) -> EnvState:
        """Blank batched state with the right shapes and dtypes."""
        cfg = self.cfg
        z = lambda *s: torch.zeros((num_envs,) + s, dtype=self.dtype, device=device)
        return EnvState(
            pos=z(cfg.n_entities, cfg.dim_p),
            vel=z(cfg.n_entities, cfg.dim_p),
            c=z(cfg.n_agents, cfg.dim_c),
            ideal_shape=z(cfg.n_landmarks, cfg.dim_p),
            ideal_vel=z(cfg.dim_p),
            t=torch.zeros(num_envs, dtype=torch.int32, device=device),
        )
