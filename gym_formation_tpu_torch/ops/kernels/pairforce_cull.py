"""K8: soft-contact forces with far pairs culled exactly, by a per-env grid.

The CUDA kernel ``csrc/pairforce_cull.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/pairforce_cull.py:collision_forces_culled``.
It computes K6's function up to the order of each receiver's sum.  Its
source note says what bounds it on the H100, why the cull is exact and how
it is laid out.

The TPU kernel sorts each env's entities by a Morton key outside its body
and skips far tile pairs; one block of the card's kernel holds one env, bins
its colliding entities into a uniform grid of cells at least
:func:`cutoff` wide (:func:`grid_cells_plain`) and evaluates only the pairs
in neighbouring cells (:func:`candidate_pairs_plain`).  The wrapper only
allocates the output and launches.  :func:`collision_forces_culled` launches
the kernel on a CUDA tensor and takes :func:`collision_forces_culled_plain`,
the JAX package's Morton order and every pair, on a CPU tensor.
``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import _device
from ...core.types import WorldCfg
from .. import _build
from . import pairforce

launches = 0

# exp(z) underflows to 0 (or a subnormal that k·exp(z) rounds to 0) below
# z = -103.98; pairs beyond dmin + CUTOFF_K · margin add exactly 0
CUTOFF_K = 104.0
_PAD_SIZE = -1.0e4  # sentinel size: folds collide=False into pen = 0
# Most cells the grid takes on one axis (the bound of the exactness proof).
MAX_AXIS_CELLS = 1024


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


def collision_forces_culled_plain(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """Plain PyTorch version of K8: pos [B, E, 2] → force [B, E, 2], in the
    dtype of ``pos``.  The sort, the pair math in Morton order over every
    pair (the cull only skips exact zeros), the receiver gate and the
    unsort."""
    order = morton_order(pos)
    sp = torch.gather(pos, -2, order[..., None].expand(pos.shape))
    sz, minv, wm, om = _device.const(_entity_table(cfg), pos)[:, order]  # each [B, E]
    dx = sp[:, :, None, 0] - sp[:, None, :, 0]  # [B, E, E] in sorted order
    dy = sp[:, :, None, 1] - sp[:, None, :, 1]
    dist = torch.hypot(dx, dy)  # not sqrt, nor exp below: see K6's plain version
    k = cfg.contact_margin
    z = -(dist - (sz[:, :, None] + sz[:, None, :])) / k
    pen = pairforce.softplus(z) * k
    ratio = wm[:, None, :] * minv[:, :, None] + om[:, None, :]
    coef = ratio * (cfg.contact_force * pen / dist.clamp_min(1e-12))
    f = torch.stack([(coef * dx).sum(-1), (coef * dy).sum(-1)], dim=-1) * (1.0 - om)[..., None]
    return torch.empty_like(f).scatter_(-2, order[..., None].expand(f.shape), f)


def _cell_width(cfg: WorldCfg) -> float:
    """The least width of a cell of K8's grid: the cutoff with a margin of
    2⁻¹⁰ for the rounding of the cell index (the source note's proof)."""
    return cutoff(cfg) * (1.0 + 2.0**-10)


def _smem_bytes(E: int) -> int:
    """The kernel's shared memory (``pairforce_cull_smem_bytes`` in the
    source): 12 words an entity padded to 32 (P, Q, slot → entity, entity →
    cell; the cell table of ``2·Ep + 1`` words) and 128 words of scratch."""
    Ep = 32 * -(-E // 32)
    return 4 * (12 * Ep + 1 + 128)


# Shared memory a block may use on the H100, opted in beyond 48 KB.
_SMEM_MAX = 232448
# Largest entity count whose grid and sorted entities fit: 4800.
MAX_ENTITIES = 32 * ((_SMEM_MAX - 4 * 129) // (4 * 12 * 32))


def grid_cells_plain(pos: torch.Tensor, cfg: WorldCfg):
    """Each entity's cell in K8's per-env grid, in the kernel's float32
    arithmetic: pos [B, E, 2] → (cell [B, E] int64, ``row · gx + column``,
    −1 where the entity does not collide; dims [B, 2] int64, (gx, gy)).

    The grid lies over the box of the env's colliding entities (a NaN
    coordinate left out of the box); ``g = floor(extent / width)`` cells an
    axis, at least 1 and at most ``MAX_AXIS_CELLS``, with width
    :func:`_cell_width`; while ``gx · gy`` exceeds ``2·Ep`` the axis with
    more cells halves its count (rounding up).  An entity's column is
    ``(x − lo) · (gx / extent)`` clamped into ``[0, gx − 1]`` (a NaN to 0) and
    truncated; its row likewise.  Every quotient is a division by a tensor,
    as the kernel's ``rn_div``."""
    p = pos.float()
    E = p.shape[1]
    collide = torch.as_tensor(np.asarray(cfg.collide, bool), device=p.device)
    width = torch.tensor(_cell_width(cfg), dtype=torch.float32, device=p.device)
    lo, extent, g = [], [], []
    for v in (p[..., 0], p[..., 1]):
        keep = collide & ~torch.isnan(v)
        lo.append(torch.where(keep, v, torch.inf).amin(-1))
        extent.append(torch.where(keep, v, -torch.inf).amax(-1) - lo[-1])
        n = torch.floor(extent[-1] / width)
        g.append(torch.where(n >= 1, n.clamp(max=MAX_AXIS_CELLS), 1.0).long())
    gx, gy = g
    cap = 2 * 32 * -(-E // 32)
    while bool((big := gx * gy > cap).any()):
        halve_x = big & (gx >= gy)
        gx, gy = torch.where(halve_x, (gx + 1) // 2, gx), torch.where(big & ~halve_x, (gy + 1) // 2, gy)
    col, row = (_axis_index(p[..., a], lo[a], extent[a], n) for a, n in ((0, gx), (1, gy)))
    cell = torch.where(collide, row * gx[:, None] + col, -1)
    return cell, torch.stack([gx, gy], -1)


def _axis_index(v, lo, extent, g):
    """The kernel's axis_index: (v − lo) · (g / extent) clamped into
    [0, g − 1] (a NaN to 0) and truncated."""
    u = (v - lo[:, None]) * (g.float() / extent)[:, None]
    u = torch.where(u >= 0, u, 0.0)
    return torch.minimum(u, (g - 1).float()[:, None]).long()


def candidate_pairs_plain(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """[B] int64: the ordered pairs (i, j) K8 evaluates, i ≠ j, i movable and
    colliding, j colliding, their cells of :func:`grid_cells_plain` at most
    one column and one row apart."""
    cell, dims = grid_cells_plain(pos, cfg)
    recv = torch.as_tensor(np.asarray(cfg.collide & cfg.movable, bool), device=pos.device)
    part = torch.as_tensor(np.asarray(cfg.collide, bool), device=pos.device)
    E = cell.shape[1]
    ok = recv[:, None] & part[None, :] & ~torch.eye(E, dtype=torch.bool, device=pos.device)
    out = []
    for c, g in zip(cell.split(256), dims.split(256)):
        col, row = c % g[:, :1], c // g[:, :1]
        near_col = (col[:, :, None] - col[:, None, :]).abs() <= 1
        near_row = (row[:, :, None] - row[:, None, :]).abs() <= 1
        out.append((near_col & near_row & ok).sum((1, 2)))
    return torch.cat(out)


def collision_forces_culled(
    pos: torch.Tensor, cfg: WorldCfg, pairs: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Contact forces pos [B, E, 2] → [B, E, 2] for any ``cfg`` with
    ``nan_guard`` (the TPU kernel asserts it too).  On the card, ``pairs``
    (int32 [B], zeroed by the caller) gains each env's count of evaluated
    ordered pairs (:func:`candidate_pairs_plain`).  The card path is one
    kernel launch: the sort by cell happens inside it."""
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
    if pairs is not None and (pairs.dtype != torch.int32 or tuple(pairs.shape) != (B,)
                              or pairs.device != pos.device):
        raise ValueError("K8 takes pairs as an int32 [B] tensor on the card")
    ent = pairforce._entity_vectors(cfg, pos)
    force = torch.empty_like(pos)
    with torch.cuda.device(pos.device):
        rc = _build.lib().pairforce_cull_launch(
            pos.data_ptr(), ent.data_ptr(), force.data_ptr(),
            None if pairs is None else pairs.data_ptr(), B, E,
            float(cfg.contact_margin), float(cfg.contact_force), _cell_width(cfg),
            torch.cuda.current_stream(pos.device).cuda_stream,
        )
    _build.check(rc, "pairforce_cull")
    global launches
    launches += 1
    return force
