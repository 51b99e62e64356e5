"""K1: soft-contact forces over a uniform all-colliding subset.

The CUDA kernel ``csrc/pairforce_sym.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/pairforce_sym.py:collision_forces_sym``.
Its source note says what bounds it on the H100 and how it is laid out: each
unordered pair once, by the pair sweep K3 and K6 run.

:func:`collision_forces_sym` is the wrapper: a CUDA tensor launches the
kernel, a CPU tensor takes :func:`collision_forces_sym_plain`, the same
function in plain PyTorch.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _device
from ...core.types import WorldCfg
from .. import _build
from .pairforce import softplus

launches = 0

# The kernel's entity limit: positions and the pair sweep's sums, 6 floats
# an entity, 144 KB of shared memory at 6144 (opted in beyond 48 KB).
# physics sends every uniform world to K1 on the ``auto`` selector.
MAX_ENTITIES = 6144


def sym_applicable(cfg: WorldCfg) -> bool:
    """True when the uniform-symmetric contact model is exact for ``cfg``:
    every entity collides, is movable, and shares one mass and one size."""
    return bool(
        np.all(cfg.collide)
        and np.all(cfg.movable)
        and np.all(np.asarray(cfg.mass) == cfg.mass[0])
        and np.all(np.asarray(cfg.size) == cfg.size[0])
    )


def _params(cfg: WorldCfg):
    return dict(
        k=float(cfg.contact_margin),
        invk=float(1.0 / cfg.contact_margin),
        cf=float(cfg.contact_force),
        dmin=float(2.0 * cfg.size[0]),
    )


def collision_forces_sym_plain(
    pos: torch.Tensor, *, k: float, invk: float, cf: float, dmin: float
) -> torch.Tensor:
    """Plain PyTorch version of K1: pos [B, E, 2] → force [B, E, 2], in the
    dtype of ``pos``.  Materializes the [B, E, E] pair planes."""
    E = pos.shape[-2]
    dx = pos[:, :, None, 0] - pos[:, None, :, 0]  # [B, E, E]
    dy = pos[:, :, None, 1] - pos[:, None, :, 1]
    s = (dx * dx + dy * dy).clamp_min(1e-24)  # nan_guard
    r = torch.rsqrt(s)
    z = (dmin - s * r) * invk
    pen = softplus(z) * k  # not torch.exp: see K6's plain version
    c = (cf * pen) * r
    c = c.masked_fill(torch.eye(E, dtype=torch.bool, device=pos.device), 0.0)
    return torch.stack([(c * dx).sum(-1), (c * dy).sum(-1)], dim=-1)


def collision_forces_sym(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """Contact forces pos [B, E, 2] → [B, E, 2] for a ``cfg`` on the
    :func:`sym_applicable` envelope with ``nan_guard``."""
    if not (cfg.nan_guard and sym_applicable(cfg)):
        raise ValueError("K1 needs nan_guard and uniform all-colliding entities")
    p = _params(cfg)
    if not _device.use_kernel(pos):
        return collision_forces_sym_plain(pos, **p)
    if pos.dtype != torch.float32 or pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"K1 takes float32 [B, E, 2], got {pos.dtype} {tuple(pos.shape)}")
    if not pos.is_contiguous():
        raise ValueError("K1 takes a contiguous pos tensor")
    B, E, _ = pos.shape
    if E > MAX_ENTITIES:
        raise ValueError(f"K1 holds at most {MAX_ENTITIES} entities per env, got {E}")
    force = torch.empty_like(pos)
    with torch.cuda.device(pos.device):
        rc = _build.lib().pairforce_sym_launch(
            pos.data_ptr(), force.data_ptr(), B, E,
            p["k"], p["invk"], p["cf"], p["dmin"],
            torch.cuda.current_stream(pos.device).cuda_stream,
        )
    _build.check(rc, "pairforce_sym")
    global launches
    launches += 1
    return force
