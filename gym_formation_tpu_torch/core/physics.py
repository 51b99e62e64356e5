"""Batched MPE point-mass physics.

PyTorch counterpart of ``gym_formation_tpu/core/physics.py``.  Every function
takes tensors with an explicit env-batch axis, ``pos``/``vel`` [B, E, P], and
the static :class:`~gym_formation_tpu_torch.core.types.WorldCfg`.

Collision dispatch (:func:`collision_forces`): the pair computation is
restricted to the colliding entities (:func:`_collide_subset`).  A subset on
the uniform envelope (:func:`~..ops.kernels.pairforce_sym.sym_applicable`,
with ``nan_guard``) goes to kernel K1, which launches on a CUDA tensor and
runs its plain version on a CPU tensor.  Any other subset runs
:func:`_collision_forces_plain` on the CPU and raises on a card, where its
kernel (the dense pair-force kernel K6) is not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _device
from ..ops.kernels import pairforce_sym
from .types import WallCfg, WorldCfg


def _collide_subset(cfg: WorldCfg):
    """Static restriction of the pair computation to colliding entities.

    A pair contributes force only when both ends collide.  In the hd
    scenarios landmarks don't, so at N=243 the live pair set is [243, 243]
    of the [486, 486] matrix, with identical results.

    Returns ``None`` when every entity collides (no restriction), else
    ``(lo, hi, idx, sub_cfg)``: ``lo:hi`` when the subset is contiguous
    (``idx`` is None), the index array ``idx`` otherwise; ``sub_cfg`` is
    None when nothing collides.
    """
    collide = np.asarray(cfg.collide, bool)
    idx = np.where(collide)[0]
    if len(idx) == cfg.n_entities:
        return None
    if len(idx) == 0:
        return (0, 0, None, None)
    k = len(idx)
    pick = lambda a: None if a is None else np.asarray(a)[idx]
    sub_cfg = dataclasses.replace(
        cfg,
        n_agents=k,
        n_landmarks=0,
        size=pick(cfg.size),
        movable=pick(cfg.movable),
        collide=pick(cfg.collide),
        mass=pick(cfg.mass),
        max_speed=pick(cfg.max_speed),
        # agent-only arrays are never read by the pair computation; keep
        # them shape-consistent with the subset entity count
        act_coef=np.zeros(k),
        u_noise=np.zeros(k),
        c_noise=np.zeros(k),
        silent=np.ones(k, bool),
        sensitivity=np.ones(k),
    )
    if np.all(np.diff(idx) == 1):
        return (int(idx[0]), int(idx[-1]) + 1, None, sub_cfg)
    return (0, 0, idx, sub_cfg)


def _subset_forces(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    if cfg.nan_guard and pairforce_sym.sym_applicable(cfg):
        return pairforce_sym.collision_forces_sym(pos.contiguous(), cfg)
    if _device.use_kernel(pos):
        raise NotImplementedError(
            "contact forces for this world (mixed masses or sizes, "
            "non-movable colliders, or nan_guard=False) need the dense "
            "pair-force kernel K6 (gym_formation_tpu/ops/pallas/pairforce.py:"
            "collision_forces_batched), which is not yet ported"
        )
    return _collision_forces_plain(pos, cfg)


def collision_forces(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """Pairwise soft-contact forces [B, E, P], restricted to the colliding
    subset and dispatched as the module docstring says."""
    sub = _collide_subset(cfg)
    if sub is None:
        return _subset_forces(pos, cfg)
    lo, hi, idx, sub_cfg = sub
    out = torch.zeros_like(pos)
    if sub_cfg is None:  # nothing collides
        return out
    if idx is None:
        out[:, lo:hi] = _subset_forces(pos[:, lo:hi], sub_cfg)
    else:
        sel = torch.as_tensor(idx, device=pos.device)
        out[:, sel] = _subset_forces(pos[:, sel], sub_cfg)
    return out


def _collision_forces_plain(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """Pairwise soft-contact forces [..., E, P], summed per entity.

    For entities i, j:

        penetration = k * logaddexp(0, -(dist - (size_i + size_j)) / k)
        F_ij        = contact_force * (pos_i - pos_j) / dist * penetration

    with the mass-ratio split ``force_on_i = Σ_j (m_j/m_i) F_ij`` when both
    ends are movable, the raw force when only i is, and nothing when i is
    not.  ``nan_guard`` keeps a zero-distance pair finite.
    """
    eps = 1e-12 if cfg.nan_guard else 0.0
    E = pos.shape[-2]
    delta = pos[..., :, None, :] - pos[..., None, :, :]  # [..., E, E, P]
    dist = torch.sqrt((delta * delta).sum(-1))  # [..., E, E]
    size = _device.const(cfg.size, pos)
    dist_min = size[:, None] + size[None, :]
    k = cfg.contact_margin
    x = -(dist - dist_min) / k
    penetration = torch.logaddexp(torch.zeros_like(x), x) * k
    coef = cfg.contact_force * penetration / dist.clamp_min(eps)
    collide = _device.const(cfg.collide, pos, torch.bool)
    movable = _device.const(cfg.movable, pos, torch.bool)
    mass = _device.const(cfg.mass, pos)
    pair_ok = (
        collide[:, None]
        & collide[None, :]
        & (movable[:, None] | movable[None, :])
        & ~torch.eye(E, dtype=torch.bool, device=pos.device)
    )
    ratio = torch.where(movable[None, :], mass[None, :] / mass[:, None], 1.0)
    w = torch.where(pair_ok & movable[:, None], coef * ratio, 0.0)
    return torch.einsum("...ij,...ijp->...ip", w, delta)


def _wall_force_single(
    pos: torch.Tensor, size: torch.Tensor, wall: WallCfg, cfg: WorldCfg
) -> torch.Tensor:
    """Force from one wall on every entity: pos [..., E, 2], size [E] →
    [..., E, 2]."""
    prll, perp = (0, 1) if wall.orient == "H" else (1, 0)
    p = pos[..., prll]
    lo, hi = wall.endpoints
    beyond = (p < lo - size) | (p > hi + size)
    inside = (p >= lo) & (p <= hi)
    dist_past_end = torch.where(p < lo, p - lo, p - hi)
    dist_past_end = torch.where(inside, 0.0, dist_past_end)
    theta = torch.where(
        inside, 0.0, torch.arcsin(torch.clamp(dist_past_end / size, -1.0, 1.0))
    )
    dist_min = torch.cos(theta) * size + 0.5 * wall.width
    delta = pos[..., perp] - wall.axis_pos
    dist = delta.abs()
    k = cfg.contact_margin
    x = -(dist - dist_min) / k
    penetration = torch.logaddexp(torch.zeros_like(x), x) * k
    eps = 1e-12 if cfg.nan_guard else 0.0
    force_mag = cfg.contact_force * delta / dist.clamp_min(eps) * penetration
    parts = [None, None]
    parts[perp] = torch.cos(theta) * force_mag
    parts[prll] = torch.sin(theta) * force_mag.abs()
    f = torch.stack(parts, dim=-1)
    return torch.where(beyond[..., None], 0.0, f)


def wall_forces(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """Sum of wall contact forces per entity [..., E, P].  Zero if no walls."""
    total = torch.zeros_like(pos)
    if not cfg.walls:
        return total
    size = _device.const(cfg.size, pos)
    movable = _device.const(cfg.movable, pos, torch.bool)[:, None]
    for wall in cfg.walls:
        f = _wall_force_single(pos, size, wall, cfg)
        total = total + torch.where(movable, f, 0.0)
    return total


def action_forces(
    u: torch.Tensor, cfg: WorldCfg, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Control forces for agents, padded with zeros for landmarks.
    u [B, N, P] → [B, E, P].  ``F = mass * (accel or 1) * u``, plus
    ``u_noise * N(0, 1)`` drawn from ``generator`` when given."""
    f_agents = _device.const(cfg.act_coef, u)[:, None] * u
    if generator is not None and np.any(cfg.u_noise > 0):
        noise = torch.randn(
            u.shape, generator=generator, device=u.device, dtype=u.dtype
        )
        f_agents = f_agents + noise * _device.const(cfg.u_noise, u)[:, None]
    pad = u.new_zeros(u.shape[:-2] + (cfg.n_landmarks, u.shape[-1]))
    return torch.cat([f_agents, pad], dim=-2)


def integrate(
    pos: torch.Tensor, vel: torch.Tensor, force: torch.Tensor, cfg: WorldCfg
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped semi-implicit Euler with per-entity speed clamp.  Non-movable
    entities keep pos/vel."""
    movable = _device.const(cfg.movable, pos, torch.bool)[:, None]
    mass = _device.const(cfg.mass, pos)[:, None]
    new_vel = vel * (1.0 - cfg.damping) + (force / mass) * cfg.dt
    if np.any(np.isfinite(cfg.max_speed)):
        max_speed = _device.const(cfg.max_speed, pos)[:, None]
        speed = torch.sqrt((new_vel * new_vel).sum(-1, keepdim=True))
        scale = torch.where(
            speed > max_speed, max_speed / speed.clamp_min(1e-12), 1.0
        )
        new_vel = new_vel * scale
    new_vel = torch.where(movable, new_vel, vel)
    new_pos = torch.where(movable, pos + new_vel * cfg.dt, pos)
    return new_pos, new_vel


def world_step(
    pos: torch.Tensor,
    vel: torch.Tensor,
    u: torch.Tensor,
    cfg: WorldCfg,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One physics step for a batch of environments.

    Args:
      pos, vel: [B, E, P] entity state, agents first.
      u: [B, n_agents, P] control (already sensitivity-scaled by the env).
      generator: draws the motor noise, where the config has any.
    """
    force = action_forces(u, cfg, generator)
    force = force + collision_forces(pos, cfg)
    if cfg.walls:
        force = force + wall_forces(pos, cfg)
    return integrate(pos, vel, force, cfg)
