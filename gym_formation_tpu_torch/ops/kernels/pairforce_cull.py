"""K8: soft-contact forces in Morton order with far tile pairs culled.

The CUDA kernel ``csrc/pairforce_cull.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/pairforce_cull.py:collision_forces_culled``.
Its source note says what bounds it on the H100, why the cull is exact and
how it is laid out.  It computes K6's function up to the order of each
receiver's sum.

The wrapper sorts each env's entities by :func:`morton_order` (PyTorch ops
on the card, as the JAX package runs its sort in XLA outside the Pallas
body); the kernel gathers in sorted order, culls, and writes each force back
to its entity.  :func:`collision_forces_culled` launches the kernel on a
CUDA tensor and takes :func:`collision_forces_culled_plain` on a CPU tensor.
``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import _device
from ...core.types import WorldCfg
from .. import _build

launches = 0

TILE = 32
# exp(z) underflows to 0 (or a subnormal that k·exp(z) rounds to 0) below
# z = -103.98; pairs beyond dmin + CUTOFF_K · margin add exactly 0
CUTOFF_K = 104.0
_PAD_SIZE = -1.0e4  # sentinel size: folds collide=False into pen = 0

# Largest entity count whose sorted positions, four per-entity vectors and
# tile boxes fit the kernel's default 48 KB of shared memory.
MAX_ENTITIES = 1984


def _spread16(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``v`` (int64) onto even bit positions."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_order(pos: torch.Tensor) -> torch.Tensor:
    """Per-env Morton (Z-curve) order of entities: pos [B, E, 2] → [B, E]
    int64, equal to the JAX package's ``morton_order``: coordinates
    quantized to 16 bits over ±4, bits interleaved, a stable argsort.  The
    shifts run in int64 with the JAX package's uint32 masks."""
    q = ((pos + 4.0) * (65535.0 / 8.0)).clamp(0.0, 65535.0).to(torch.int64)
    key = _spread16(q[..., 0]) | (_spread16(q[..., 1]) << 1)
    return torch.argsort(key, dim=-1, stable=True)


def cutoff(cfg: WorldCfg) -> float:
    """Box distance beyond which every pair adds exactly 0."""
    size = np.where(cfg.collide, cfg.size, 0.0)
    return float(2.0 * np.max(size) + CUTOFF_K * cfg.contact_margin)


def _entity_table(cfg: WorldCfg) -> np.ndarray:
    """[4, E] float64: sentinel-folded size, 1/m, m·movable, 1 − movable."""
    movable = np.asarray(cfg.movable, np.float64)
    mass = np.asarray(cfg.mass, np.float64)
    return np.stack([
        np.where(cfg.collide, cfg.size, _PAD_SIZE),
        1.0 / mass,
        movable * mass,
        1.0 - movable,
    ])


def _sorted(pos: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.gather(pos, -2, order[..., None].expand(pos.shape))


def collision_forces_culled_plain(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """Plain PyTorch version of K8: pos [B, E, 2] → force [B, E, 2], in the
    dtype of ``pos``.  The sort, the pair math in Morton order over every
    pair (the cull only skips exact zeros), the receiver gate and the
    unsort."""
    order = morton_order(pos)
    sp = _sorted(pos, order)
    sz, minv, wm, om = _device.const(_entity_table(cfg), pos)[:, order]  # each [B, E]
    dx = sp[:, :, None, 0] - sp[:, None, :, 0]  # [B, E, E] in sorted order
    dy = sp[:, :, None, 1] - sp[:, None, :, 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    k = cfg.contact_margin
    z = -(dist - (sz[:, :, None] + sz[:, None, :])) / k
    pen = (z.clamp_min(0.0) + torch.log1p(torch.exp(-z.abs()))) * k
    ratio = wm[:, None, :] * minv[:, :, None] + om[:, None, :]
    coef = ratio * (cfg.contact_force * pen / dist.clamp_min(1e-12))
    f = torch.stack([(coef * dx).sum(-1), (coef * dy).sum(-1)], dim=-1) * (1.0 - om)[..., None]
    return torch.empty_like(f).scatter_(-2, order[..., None].expand(f.shape), f)


def tile_pairs_plain(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """[B] int64: the tile pairs (row tile, column tile) of 32 sorted
    entities whose boxes are within the cutoff, the ones K8 evaluates."""
    sp = _sorted(pos, morton_order(pos)).float()
    B, E, _ = sp.shape
    T = -(-E // TILE)
    # pad with the last sorted entity: the last tile's box does not grow
    sp = torch.cat([sp, sp[:, -1:].expand(B, T * TILE - E, 2)], 1).reshape(B, T, TILE, 2)
    lo, hi = sp.amin(2), sp.amax(2)  # [B, T, 2]
    c = torch.tensor(cutoff(cfg), dtype=torch.float32, device=pos.device)
    near = ((lo[:, None, :] <= hi[:, :, None] + c) & (hi[:, None, :] >= lo[:, :, None] - c)).all(-1)
    return near.sum((1, 2))


def collision_forces_culled(
    pos: torch.Tensor, cfg: WorldCfg, tiles: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Contact forces pos [B, E, 2] → [B, E, 2] for any ``cfg`` with
    ``nan_guard`` (the TPU kernel asserts it too).  On the card, ``tiles``
    (int32 [B], zeroed by the caller) gains each env's count of evaluated
    tile pairs."""
    if not cfg.nan_guard:
        raise ValueError("K8 needs nan_guard")
    if not _device.use_kernel(pos):
        return collision_forces_culled_plain(pos, cfg)
    if pos.dtype != torch.float32 or pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"K8 takes float32 [B, E, 2], got {pos.dtype} {tuple(pos.shape)}")
    if not pos.is_contiguous():
        raise ValueError("K8 takes a contiguous pos tensor")
    B, E, _ = pos.shape
    if E != cfg.n_entities:
        raise ValueError(f"K8: pos has {E} entities, the cfg {cfg.n_entities}")
    if E > MAX_ENTITIES:
        raise ValueError(f"K8 holds at most {MAX_ENTITIES} entities per env, got {E}")
    if tiles is not None and (tiles.dtype != torch.int32 or tuple(tiles.shape) != (B,)
                              or tiles.device != pos.device):
        raise ValueError("K8 takes tiles as an int32 [B] tensor on the card")
    order = morton_order(pos)
    ent = _device.const(_entity_table(cfg), pos, torch.float32)
    force = torch.empty_like(pos)
    rc = _build.lib().pairforce_cull_launch(
        pos.data_ptr(), order.data_ptr(), ent.data_ptr(), force.data_ptr(),
        None if tiles is None else tiles.data_ptr(), B, E,
        float(cfg.contact_margin), float(cfg.contact_force), cutoff(cfg),
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    _build.check(rc, "pairforce_cull")
    global launches
    launches += 1
    return force
