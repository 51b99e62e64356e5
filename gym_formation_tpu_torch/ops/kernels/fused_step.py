"""K3: one fused formation_hd env step (policy, physics, reward statistics).

The CUDA kernel ``csrc/fused_step.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/fused_step.py:fused_hd_step``, with its
in-kernel policy ``gym_formation_tpu/models/bfs_planes.py:bfs_ez_planes``.
Its source note says what bounds it on the H100 and how it is laid out.

:func:`fused_hd_step` is the wrapper: a CUDA tensor launches the kernel, a
CPU tensor takes :func:`fused_hd_step_plain`, the same function built from
the port's pieces (K1's and K2's plain versions, ``physics.integrate`` and
:func:`~gym_formation_tpu_torch.models.bfs_planes.bfs_ez_planes`).
``launches`` counts kernel launches.

The TPU entry's ``tile``, ``interpret`` and ``fold`` arguments choose the
TPU kernel's tiling and lowering and have no counterpart here, and neither
has its ``[Ep, Bp]`` plane entry ``fused_hd_step_planes``: the kernel reads
the ``[B, N, 2]`` tensors themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ... import _device
from ...core import physics
from ...core.types import WorldCfg
from ...models.bfs_planes import bfs_ez_planes
from .. import _build
from . import pairforce_sym, reward_sym

launches = 0

# Shared memory a block may use on the H100, opted in beyond 48 KB.
_SMEM_FLOATS = 232448 // 4


def _smem_floats(N: int, bfs: bool) -> int:
    """The kernel's shared memory (``fused_step_smem_floats`` in the
    source): 13 floats an agent padded to tiles of 32, 2 an agent and 32,
    and the policy's pyramid and buffers."""
    Ep = 32 * -(-N // 32)
    return 13 * Ep + 2 * N + 32 + ((4 * ((N - 1) // 2) + 4 * N) if bfs else 0)


def _validate(cfg: WorldCfg, N: int, stats: str, bfs_L, ideal_vel, act_scale) -> None:
    """The TPU entry's preconditions, raised as errors."""
    if not cfg.nan_guard:
        raise ValueError("the fused step requires nan_guard")
    if not pairforce_sym.sym_applicable(cfg):
        raise ValueError("the fused step requires uniform all-colliding, movable entities")
    if cfg.walls:
        raise ValueError("the fused step does not support walls")
    if stats not in ("pre", "post"):
        raise ValueError(f"stats must be 'pre' or 'post', got {stats!r}")
    if bfs_L is not None and not (3**bfs_L == N and ideal_vel is not None and act_scale is not None):
        raise ValueError("bfs_L needs 3**bfs_L == N agents, ideal_vel and act_scale")


def _max_speed(cfg: WorldCfg) -> Optional[float]:
    return float(cfg.max_speed[0]) if np.any(np.isfinite(cfg.max_speed)) else None


def fused_hd_step_plain(
    apos: torch.Tensor,
    avel: torch.Tensor,
    aforce: Optional[torch.Tensor],
    ishape: torch.Tensor,
    cfg: WorldCfg,
    *,
    thresh: float,
    stats: str = "pre",
    bfs_L: Optional[int] = None,
    ideal_vel: Optional[torch.Tensor] = None,
    act_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3, in the dtype of ``apos``; arguments and
    results as :func:`fused_hd_step`."""
    _validate(cfg, apos.shape[-2], stats, bfs_L, ideal_vel, act_scale)
    force = pairforce_sym.collision_forces_sym_plain(apos, **pairforce_sym._params(cfg))
    if bfs_L is None:
        force = force + aforce
    else:
        ax, ay = bfs_ez_planes(
            apos[..., 0].T, apos[..., 1].T, ishape[..., 0].T, ishape[..., 1].T,
            ideal_vel[:, 0], ideal_vel[:, 1], bfs_L,
        )
        force = force + act_scale * torch.stack([ax.T, ay.T], dim=-1)
    npos, nvel = physics.integrate(apos, avel, force, cfg)
    haus, ncoll = reward_sym.hd_reward_stats_sym_plain(
        apos if stats == "pre" else npos, ishape, thresh=thresh
    )
    return npos, nvel, haus, ncoll


def _rows_contiguous(t: torch.Tensor) -> bool:
    """[B, N, 2] with each env's N x 2 block contiguous (a batch stride of
    its own, as a slice of the agents out of all entities has)."""
    return t.stride(-1) == 1 and t.stride(-2) == 2


def fused_hd_step(
    apos: torch.Tensor,
    avel: torch.Tensor,
    aforce: Optional[torch.Tensor],
    ishape: torch.Tensor,
    cfg: WorldCfg,
    *,
    thresh: float,
    stats: str = "pre",
    bfs_L: Optional[int] = None,
    ideal_vel: Optional[torch.Tensor] = None,
    act_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused physics + reward step on the uniform colliding subset.

    Args:
      apos, avel: [B, N, 2] agent positions and velocities.
      aforce: [B, N, 2] action forces (control already decoded and scaled:
        ``act_coef * sensitivity * policy output``); ignored with ``bfs_L``.
      ishape: [B, N, 2] centred ideal shape.
      cfg: world config of the subset (``sym_applicable`` must hold).
      thresh: the uniform collision-count distance.
      stats: "post" (statistics of the integrated positions) or "pre"
        (statistics of the input positions, which the fused rollout uses to
        finalize the previous step's reward).
      bfs_L: run the arity-3 BFS + ezpolicy expansion of ``3**bfs_L == N``
        agents first, and use ``act_scale`` times its actions as the action
        forces; ``ideal_vel`` [B, 2] is the root commanded velocity.

    Returns ``(new_pos [B, N, 2], new_vel [B, N, 2], haus [B],
    ncoll [B, N])``.
    """
    B, N, _ = apos.shape
    _validate(cfg, N, stats, bfs_L, ideal_vel, act_scale)
    if not _device.use_kernel(apos):
        return fused_hd_step_plain(
            apos, avel, aforce, ishape, cfg, thresh=thresh, stats=stats,
            bfs_L=bfs_L, ideal_vel=ideal_vel, act_scale=act_scale,
        )
    bfs = bfs_L is not None
    named = [("apos", apos, (B, N, 2)), ("avel", avel, (B, N, 2)), ("ishape", ishape, (B, N, 2))]
    named.append(("ideal_vel", ideal_vel, (B, 2)) if bfs else ("aforce", aforce, (B, N, 2)))
    for name, t, shape in named:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != apos.device:
            raise ValueError(f"K3 takes float32 {name} of shape {shape} on the card, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        ok = _rows_contiguous(t) if name in ("apos", "avel") else t.is_contiguous()
        if not ok:
            raise ValueError(f"K3 takes a contiguous {name} tensor")
    if _smem_floats(N, bfs) > _SMEM_FLOATS:
        raise ValueError(f"K3 does not hold N={N} agents (bfs={bfs}) in the card's shared memory")
    ms = _max_speed(cfg)
    npos = torch.empty(B, N, 2, dtype=torch.float32, device=apos.device)
    nvel = torch.empty_like(npos)
    haus = torch.empty(B, dtype=torch.float32, device=apos.device)
    ncoll = torch.empty(B, N, dtype=torch.float32, device=apos.device)
    p = pairforce_sym._params(cfg)
    rc = _build.lib().fused_step_launch(
        apos.data_ptr(), avel.data_ptr(),
        None if bfs else aforce.data_ptr(), ishape.data_ptr(),
        ideal_vel.data_ptr() if bfs else None,
        npos.data_ptr(), nvel.data_ptr(), haus.data_ptr(), ncoll.data_ptr(),
        B, N, apos.stride(0), avel.stride(0), bfs_L or 0, int(stats == "post"),
        p["k"], p["invk"], p["cf"], p["dmin"], float(thresh) * float(thresh),
        float(1.0 - cfg.damping), float(cfg.dt / cfg.mass[0]), float(cfg.dt),
        float("inf") if ms is None else ms, float(act_scale or 0.0),
        torch.cuda.current_stream(apos.device).cuda_stream,
    )
    _build.check(rc, "fused_step")
    global launches
    launches += 1
    return npos, nvel, haus, ncoll
