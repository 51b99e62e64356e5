"""K6: soft-contact forces over any colliding subset (the dense pair kernel).

The CUDA kernel ``csrc/pairforce.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/pairforce.py:collision_forces_batched``.
Its source note says what bounds it on the H100 and how it is laid out.

Unlike K1 it takes per-entity sizes, masses and masks: the subset may mix
sizes (hd_obs: agents 0.1, obstacles 0.15), masses and immovable or
non-colliding members.  The TPU kernel reads a static ``[Ep, Ep]`` pair
table ``pairc = mask · (m_j/m_i | 1)``; the card's kernel keeps two float4s
an entity in shared memory, evaluates each unordered pair once and weighs
its term for each side on the fly.

:func:`collision_forces_batched` is the wrapper: a CUDA tensor launches the
kernel, a CPU tensor takes :func:`collision_forces_batched_plain`, the same
function in plain PyTorch.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ... import _device
from ...core.types import WorldCfg
from .. import _build

launches = 0

# Shared memory a block may use on the H100, opted in beyond 48 KB.
_SMEM_MAX = 232448


def _smem_bytes(E: int) -> int:
    """The kernel's shared memory (``pairforce_smem_bytes`` in the source):
    12 floats an entity padded to tiles of 32, and a flag word a tile."""
    T = -(-E // 32)
    return 4 * (12 * 32 * T + T)


# Largest entity count whose tiles fit the card's shared memory: 4800.
MAX_ENTITIES = 32 * (_SMEM_MAX // _smem_bytes(32))


def _pair_tables(cfg: WorldCfg):
    """(pairc [E, E], dist_min [E, E]) in float64: the TPU kernel's static
    tables (``pairforce.py:_static_tables``) without the lane padding."""
    collide, movable, mass = cfg.collide, cfg.movable, np.asarray(cfg.mass, np.float64)
    pair_ok = (
        collide[:, None]
        & collide[None, :]
        & (movable[:, None] | movable[None, :])
        & ~np.eye(cfg.n_entities, dtype=bool)
    )
    ratio = np.where(movable[None, :], mass[None, :] / mass[:, None], 1.0)
    pairc = np.where(pair_ok & movable[:, None], ratio, 0.0)
    size = np.asarray(cfg.size, np.float64)
    return pairc, size[:, None] + size[None, :]


def softplus(z: torch.Tensor) -> torch.Tensor:
    """The stable softplus ``logaddexp(0, z) = max(z, 0) + log1p(exp(-|z|))``,
    the exponential and log1p by ATen's own softplus kernel (see
    :func:`collision_forces_batched_plain` for why not ``torch.exp``)."""
    return z.clamp_min(0.0) + F.softplus(-z.abs())


def collision_forces_batched_plain(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """Plain PyTorch version of K6: pos [B, E, 2] → force [B, E, 2], in the
    dtype of ``pos``.  Materializes the [B, E, E] pair planes.

    For entities i, j, with ``z = -(d_ij - (s_i + s_j)) / k``:

        F_i = Σ_j pairc_ij · cf · k · softplus(z) / max(d_ij, eps) · (p_i - p_j)

    ``eps`` is 1e-12 under ``nan_guard`` and 0 otherwise (the original's
    0/0 NaN at zero distance).  This is also the physics' plain path for
    worlds that no kernel covers (``nan_guard=False``).

    The distance is ``torch.hypot`` and the softplus :func:`softplus`, never
    ``torch.sqrt`` or ``torch.exp``: on the CPU those two call MKL's vector
    math library from each intra-op thread, and the first such call of a
    process, when it is split over the threads, can compute one thread's
    share with a less accurate routine (about 2⁻¹² relative; MKL's lazy
    set-up races).  Amplified by ``1/k``, that moved forces by 3e-3 now and
    then.  ``hypot`` and ``softplus`` are ATen's own vectorised kernels and
    give the same bits on every call."""
    pairc, dist_min = _pair_tables(cfg)
    pairc, dist_min = _device.const(pairc, pos), _device.const(dist_min, pos)
    eps = 1e-12 if cfg.nan_guard else 0.0
    dx = pos[..., :, None, 0] - pos[..., None, :, 0]  # [B, E, E]
    dy = pos[..., :, None, 1] - pos[..., None, :, 1]
    dist = torch.hypot(dx, dy)
    k = cfg.contact_margin
    z = -(dist - dist_min) / k
    pen = softplus(z) * k
    # where, not a product, off the pair set: unguarded, the diagonal's 0/0
    # would otherwise leak in as 0 · NaN
    coef = torch.where(pairc != 0, pairc * (cfg.contact_force * pen / dist.clamp_min(eps)), 0.0)
    return torch.stack([(coef * dx).sum(-1), (coef * dy).sum(-1)], dim=-1)


def _entity_vectors(cfg: WorldCfg, like: torch.Tensor) -> torch.Tensor:
    """[4, E] float32 on ``like``'s device: size, mass, movable, collide."""
    v = np.stack([cfg.size, cfg.mass, cfg.movable, cfg.collide]).astype(np.float32)
    return _device.const(v, like, torch.float32)


def collision_forces_batched(pos: torch.Tensor, cfg: WorldCfg) -> torch.Tensor:
    """Contact forces pos [B, E, 2] → [B, E, 2] for any ``cfg`` with
    ``nan_guard`` (the TPU kernel asserts it too)."""
    if not cfg.nan_guard:
        raise ValueError("K6 needs nan_guard")
    if not _device.use_kernel(pos):
        return collision_forces_batched_plain(pos, cfg)
    if pos.dtype != torch.float32 or pos.dim() != 3 or pos.shape[-1] != 2:
        raise ValueError(f"K6 takes float32 [B, E, 2], got {pos.dtype} {tuple(pos.shape)}")
    if not pos.is_contiguous():
        raise ValueError("K6 takes a contiguous pos tensor")
    B, E, _ = pos.shape
    if E != cfg.n_entities:
        raise ValueError(f"K6: pos has {E} entities, the cfg {cfg.n_entities}")
    if E > MAX_ENTITIES:
        raise ValueError(f"K6 holds at most {MAX_ENTITIES} entities per env, got {E}")
    ent = _entity_vectors(cfg, pos)
    force = torch.empty_like(pos)
    with torch.cuda.device(pos.device):
        rc = _build.lib().pairforce_launch(
            pos.data_ptr(), ent.data_ptr(), force.data_ptr(), B, E,
            float(cfg.contact_margin), float(cfg.contact_force),
            torch.cuda.current_stream(pos.device).cuda_stream,
        )
    _build.check(rc, "pairforce")
    global launches
    launches += 1
    return force
