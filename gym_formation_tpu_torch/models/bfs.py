"""Hierarchical BFS policy expansion, level-batched.

PyTorch counterpart of ``gym_formation_tpu/models/bfs.py``.  One n-agent
policy is run over n^L agents by treating group centroids as meta-agents.
All groups of one level are coarsened at once and evaluated in one batched
policy call, so the depth-L expansion costs L calls, each over B·n^(ℓ+1)
rows.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..envs.scenario import _drop_diag


def num_layers(num_agents: int, n_per_layer: int) -> int:
    """L such that n_per_layer**L == num_agents; raises if none exists."""
    L = int(round(np.log(num_agents) / np.log(n_per_layer)))
    if n_per_layer**L != num_agents:
        raise ValueError("Observation shape error!")
    return L


def bfs_actions(
    policy_fn: Callable[[torch.Tensor], torch.Tensor],
    obs: torch.Tensor,
    n_per_layer: int,
) -> torch.Tensor:
    """Expand one n-agent policy over n^L agents: obs [B, N, 6N] → [B, N, 2].

    ``policy_fn`` maps 6n-wide observations [M, 6n] → [M, 2] actions (e.g.
    :func:`~gym_formation_tpu_torch.models.scripted.ezpolicy_batched`).
    """
    B, N, _ = obs.shape
    # common frame: agent 0's relative view with itself at the origin
    P = torch.cat(
        [obs.new_zeros(B, 1, 2), obs[:, 0, 2 : 2 * N].reshape(B, N - 1, 2)], dim=1
    )
    V = obs[:, :, :2]
    S = obs[:, 0, 4 * N - 2 : 6 * N - 2].reshape(B, N, 2)
    root_vel = obs[:, 0, 6 * N - 2 :]
    return _expand(policy_fn, P, V, S, root_vel, n_per_layer)


def bfs_actions_from_state(
    policy_fn: Callable[[torch.Tensor], torch.Tensor],
    scenario,
    state,
    n_per_layer: int,
) -> torch.Tensor:
    """:func:`bfs_actions` fed directly from a batched ``EnvState``: the
    same actions without building the [B, N, 6N] observation.  The expansion
    reads four O(N) quantities: agent positions in a common frame, agent
    velocities, the ideal shape and the commanded root velocity."""
    pos = scenario.agent_pos(state)
    P = pos - pos[:, :1]
    return _expand(
        policy_fn,
        P,
        scenario.agent_vel(state),
        state.ideal_shape,
        state.ideal_vel,
        n_per_layer,
    )


def _expand(
    policy_fn: Callable[[torch.Tensor], torch.Tensor],
    P: torch.Tensor,
    V: torch.Tensor,
    S: torch.Tensor,
    root_vel: torch.Tensor,
    n: int,
) -> torch.Tensor:
    """Level-batched expansion core: positions [B, N, 2] (any common frame),
    velocities [B, N, 2], ideal shape [B, N, 2], root velocity [B, 2]."""
    B, N, _ = P.shape
    L = num_layers(N, n)
    parent_vel = root_vel[:, None, :]  # [B, 1, 2]: one group at the root
    out = None
    for l in range(L):
        G = n**l
        m = N // (G * n)  # block size at this level
        C = P.reshape(B, G, n, m, 2).mean(3)  # [B, G, n, 2] block centroids
        T = S.reshape(B, G, n, m, 2).mean(3)  # [B, G, n, 2] block targets
        leaders = V.reshape(B, G, n, m, 2)[:, :, :, 0]  # leader velocities
        rel = C[:, :, None, :, :] - C[:, :, :, None, :]  # [B, G, i, k, 2] = C_k − C_i
        cur_shape = _drop_diag(rel.reshape(B * G, n, n, 2)).reshape(B, G, n, 2 * (n - 1))
        obs_in = torch.cat(
            [
                leaders,
                cur_shape,
                P.new_zeros(B, G, n, 2 * (n - 1)),  # comm
                T.reshape(B, G, 1, 2 * n).expand(B, G, n, 2 * n),
                parent_vel.reshape(B, G, 1, 2).expand(B, G, n, 2),
            ],
            dim=-1,
        ).reshape(B * G * n, 6 * n)
        out = (policy_fn(obs_in) * (L - l)).reshape(B, G * n, 2)
        parent_vel = out  # the next level has G*n groups
    return out  # [B, N, 2], row g*n+i == agent g*n+i
