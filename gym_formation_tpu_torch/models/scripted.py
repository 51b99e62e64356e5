"""Scripted greedy formation policy (`ezpolicy`).

PyTorch counterpart of ``gym_formation_tpu/models/scripted.py``.  The
original walks one observation at a time through a Python loop with an early
``break``; here the rank walk is a masked argmin over tensors with any
leading batch shape.
"""

from __future__ import annotations

import torch


def parse_hd_obs(obs: torch.Tensor, num_agents: int):
    """Split 6N-wide formation_hd observations [..., 6N] into
    (p_vel [..., 2], other_pos [..., 2N−2], ideal_shape [..., N, 2],
    ideal_vel [..., 2])."""
    n = num_agents
    p_vel = obs[..., :2]
    other_pos = obs[..., 2 : 2 * n]
    ideal_shape = obs[..., 4 * n - 2 : 6 * n - 2].reshape(*obs.shape[:-1], n, 2)
    ideal_vel = obs[..., 6 * n - 2 :]
    return p_vel, other_pos, ideal_shape, ideal_vel


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def ezpolicy(obs: torch.Tensor, num_agents: int = None) -> torch.Tensor:
    """Actions [..., 2] from observations [..., 6N], one per row.

    Walk the ideal vertices in order of distance from self; claim the first
    whose nearest agent is self, falling back to the farthest vertex.  Then
    ``act = clip(0.5 * (vertex − self), ±1)`` plus the ideal velocity scaled
    by 1.0 when the formation error < 0.01, else 0.3.
    """
    if num_agents is None:
        if obs.shape[-1] % 6:
            raise ValueError(f"obs width {obs.shape[-1]} is not 6N")
        num_agents = obs.shape[-1] // 6
    n = num_agents
    lead = obs.shape[:-1]
    _, other_pos, ideal_shape, ideal_vel = parse_hd_obs(obs, n)
    ideal_shape = ideal_shape - ideal_shape.mean(-2, keepdim=True)
    # current shape in the self frame: the others, then self at the end
    cur = torch.cat([other_pos.reshape(*lead, n - 1, 2), obs.new_zeros(*lead, 1, 2)], dim=-2)
    cur = cur - cur.mean(-2, keepdim=True)
    me = cur[..., -1, :]
    # "first ranked vertex whose closest agent is self" == argmin of d_self
    # over those vertices: argsort and argmin both break ties by lowest index
    d_self = _norm(me[..., None, :] - ideal_shape)  # [..., vertex]
    d_agent_vertex = _norm(cur[..., :, None, :] - ideal_shape[..., None, :, :])
    closest = torch.argmin(d_agent_vertex, dim=-2)  # [..., vertex], first on ties
    ok = closest == (n - 1)
    # fallback = the farthest vertex, highest index among ties (the last
    # element of an argsort): argmax of the reversed distances
    far = (n - 1) - torch.argmax(d_self.flip(-1), dim=-1)
    ok = ok | (torch.arange(n, device=obs.device) == far[..., None])
    pick = torch.argmin(torch.where(ok, d_self, torch.inf), dim=-1)
    vertex = torch.gather(ideal_shape, -2, pick[..., None, None].expand(*lead, 1, 2))[..., 0, :]
    act = torch.clamp(0.5 * (vertex - me), -1.0, 1.0)
    diff = ideal_shape - cur
    settled = torch.sqrt((diff * diff).sum((-2, -1))) < 0.01
    gain = obs.new_full(settled.shape, 0.3).masked_fill(settled, 1.0)
    return act + ideal_vel * gain[..., None]


def ezpolicy_batched(obs: torch.Tensor) -> torch.Tensor:
    """[..., N, 6N] observations → [..., N, 2] actions."""
    return ezpolicy(obs, obs.shape[-1] // 6)
