"""Batched MPE point-mass physics.

PyTorch counterpart of ``gym_formation_tpu/core/physics.py``.  Every function
takes tensors with an explicit env-batch axis, ``pos``/``vel`` [B, E, P], and
the static :class:`~gym_formation_tpu_torch.core.types.WorldCfg`.

Collision dispatch (:func:`collision_forces`): the pair computation is
restricted to the colliding entities (:func:`_collide_subset`), and the
subset goes to a pair-force kernel chosen by :func:`set_pallas_impl`, with
the JAX package's names and semantics:

- ``"auto"`` (default): K1 (``ops/kernels/pairforce_sym.py``) on the
  uniform envelope (:func:`~..ops.kernels.pairforce_sym.sym_applicable`),
  else K6, the dense kernel (``ops/kernels/pairforce.py``);
- ``"dense"``: K6 on any subset;
- ``"cull"``: K8, Morton-sorted with far tile pairs culled
  (``ops/kernels/pairforce_cull.py``), on any subset;
- ``"sym"``: K1, raising ``ValueError`` off its envelope.

Each kernel launches on a CUDA tensor and runs its plain version on a CPU
tensor.  A world with ``nan_guard=False`` has no kernel in either package:
it runs the plain path on the CPU and raises on a card.

:func:`set_reward_impl` chooses the formation_hd reward-statistics kernel in
the same way (``envs/formation_hd.py``).  The JAX package's third selector,
``set_pallas_mode``, picks between Pallas and XLA by platform and entity
count; the port launches its kernels on every CUDA tensor at every entity
count, so it has none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _device
from ..ops.kernels import pairforce, pairforce_cull, pairforce_sym
from ..parallel.mesh import draw_rows
from .types import WallCfg, WorldCfg

PALLAS_IMPLS = ("auto", "dense", "cull", "sym")
REWARD_IMPLS = ("auto", "rowmajor", "sym")
_PALLAS_IMPL = "auto"
_REWARD_IMPL = "auto"


def set_pallas_impl(impl: str) -> None:
    """Pair-force kernel selector: ``"auto"``, ``"dense"`` (K6), ``"cull"``
    (K8) or ``"sym"`` (K1); see the module docstring."""
    if impl not in PALLAS_IMPLS:
        raise ValueError(f"pallas impl must be one of {PALLAS_IMPLS}, got {impl!r}")
    global _PALLAS_IMPL
    _PALLAS_IMPL = impl


def set_reward_impl(impl: str) -> None:
    """formation_hd reward-statistics selector: ``"auto"`` and ``"sym"``
    take K2, ``"rowmajor"`` K7; ``"sym"`` raises where agent sizes differ."""
    if impl not in REWARD_IMPLS:
        raise ValueError(f"reward impl must be one of {REWARD_IMPLS}, got {impl!r}")
    global _REWARD_IMPL
    _REWARD_IMPL = impl


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
    if not cfg.nan_guard:
        if _device.use_kernel(pos):
            raise NotImplementedError(
                "contact forces with nan_guard=False have no kernel (the JAX "
                "package's pair kernels assert nan_guard too): run on the CPU"
            )
        return _collision_forces_plain(pos, cfg)
    pos = pos.contiguous()
    if _PALLAS_IMPL == "cull":
        return pairforce_cull.collision_forces_culled(pos, cfg)
    sym = pairforce_sym.sym_applicable(cfg)
    if _PALLAS_IMPL == "sym" and not sym:
        raise ValueError(
            "set_pallas_impl('sym') forced on a world outside K1's envelope "
            "(needs uniform mass and size, every entity colliding and movable)"
        )
    if _PALLAS_IMPL in ("auto", "sym") and sym:
        return pairforce_sym.collision_forces_sym(pos, cfg)
    return pairforce.collision_forces_batched(pos, cfg)


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


# The plain dense path: K6's plain version, which honours nan_guard.
_collision_forces_plain = pairforce.collision_forces_batched_plain


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
    u: torch.Tensor, cfg: WorldCfg, generator: Optional[torch.Generator] = None, mesh=None
) -> torch.Tensor:
    """Control forces for agents, padded with zeros for landmarks.
    u [B, N, P] → [B, E, P].  ``F = mass * (accel or 1) * u``, plus
    ``u_noise * N(0, 1)`` drawn from ``generator`` when given (at the global
    batch's shape under a data-parallel ``mesh``, the rank's rows kept)."""
    f_agents = _device.const(cfg.act_coef, u)[:, None] * u
    if generator is not None and np.any(cfg.u_noise > 0):
        noise = draw_rows(
            lambda s: torch.randn(s, generator=generator, device=u.device, dtype=u.dtype), u.shape, mesh
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
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One physics step for a batch of environments.

    Args:
      pos, vel: [B, E, P] entity state, agents first.
      u: [B, n_agents, P] control (already sensitivity-scaled by the env).
      generator: draws the motor noise, where the config has any.
      mesh: the data-parallel mesh of the batch (the noise's draws).
    """
    force = action_forces(u, cfg, generator, mesh)
    force = force + collision_forces(pos, cfg)
    if cfg.walls:
        force = force + wall_forces(pos, cfg)
    return integrate(pos, vel, force, cfg)
