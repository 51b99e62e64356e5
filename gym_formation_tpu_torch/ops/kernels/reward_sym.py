"""K2: Hausdorff and collision statistics of the formation_hd reward.

The CUDA kernel ``csrc/reward_sym.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/reward_sym.py:hd_reward_stats_sym``.
Its source note says what bounds it on the H100 and how it is laid out.

:func:`hd_reward_stats_sym` is the wrapper: a CUDA tensor launches the
kernel, a CPU tensor takes :func:`hd_reward_stats_sym_plain`, the same
function in plain PyTorch.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ... import _device
from .. import _build

launches = 0

_SMEM_MAX = 232448  # bytes of shared memory a block may use on the H100, opted in beyond 48 KB


def tile_side(N: int) -> int:
    """R, the side of a thread's register tile at N agents, passed to the
    launcher of ``csrc/reward_sym.cu``: the smallest of 2, 4, 8, 16 whose
    super-tile of 16 R agents holds N, else 16."""
    return next((R for R in (2, 4, 8) if 16 * R >= N), 16)


def _padded(N: int) -> int:
    S = 16 * tile_side(N)
    return S * -(-N // S)


def _smem_bytes(N: int) -> int:
    """The kernel's shared memory, passed to its launcher: 9 words an agent
    (raw, centred, shape; row and column minima; count), padded to a
    multiple of the super-tile, and 32 of scratch."""
    return 4 * (9 * _padded(N) + 32)


# Largest agent count whose padded tiles fit the card's shared memory: 6400.
MAX_AGENTS = 256 * ((_SMEM_MAX // 4 - 32) // (9 * 256))


def tile_schedule_plain(N: int):
    """K2's schedule at N agents, in numpy: (dist [N, N], pair [N, N]) int64,
    how many times the kernel computes the distance of (agent i, vertex j),
    and how many times it tests the unordered pair {i, j} (at [min, max]).

    With R = :func:`tile_side` (N) and super-tiles of S = 16 R, thread
    (a, b) of a super-tile takes agents ``a + 16 k`` and vertices (or
    partner agents) ``b + 16 m``, k, m < R; the counts take super-tiles
    P <= Q, in P == Q the pairs m > k, and m == k where a < b
    (``hd_stats_tiles`` in ``csrc/common.cuh``).  Pads (indices >= N) are
    left out."""
    R = tile_side(N)
    S, T = 16 * R, _padded(N) // (16 * R)
    a, b = (x.ravel() for x in np.meshgrid(np.arange(16), np.arange(16), indexing="ij"))
    k, m = (x.ravel() for x in np.meshgrid(np.arange(R), np.arange(R), indexing="ij"))
    a, b, k, m = a[:, None], b[:, None], k[None, :], m[None, :]
    dist = np.zeros(N * N, np.int64)
    pair = np.zeros(N * N, np.int64)
    for P in range(T):
        for Q in range(T):
            i, j = P * S + a + 16 * k, Q * S + b + 16 * m
            ok = (i < N) & (j < N)
            dist += np.bincount((i * N + j)[ok], minlength=N * N)
            if P <= Q:
                take = ok & ((P < Q) | (m > k) | ((m == k) & (a < b)))
                lo, hi = np.minimum(i, j)[take], np.maximum(i, j)[take]
                pair += np.bincount(lo * N + hi, minlength=N * N)
    return dist.reshape(N, N), pair.reshape(N, N)


def hd_reward_stats_sym_plain(
    apos: torch.Tensor,
    ishape: torch.Tensor,
    *,
    thresh: float,
    mask: Optional[torch.Tensor] = None,
    fallback: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2.  ``apos`` [B, N, 2] raw agent positions,
    ``ishape`` [B, N, 2] centred ideal shape → (haus [B], ncoll [B, N]).

    Squared distances feed the min/max reductions and one sqrt is taken on
    the reduced value; collisions compare d² with thresh² on the raw
    positions, each square rounded on its own (no fused multiply-add).

    With ``mask`` [B] bool and ``fallback`` (haus [B], ncoll [B, N]), envs
    whose mask is False return their fallback rows instead."""
    N = apos.shape[-2]
    c = apos - apos.mean(-2, keepdim=True)
    dx = c[:, :, None, 0] - ishape[:, None, :, 0]  # [B, agent, vertex]
    dy = c[:, :, None, 1] - ishape[:, None, :, 1]
    d2 = dx * dx + dy * dy
    haus = torch.sqrt(torch.maximum(d2.amin(2).amax(1), d2.amin(1).amax(1)))
    gx = apos[:, :, None, 0] - apos[:, None, :, 0]  # [B, agent, agent]
    gy = apos[:, :, None, 1] - apos[:, None, :, 1]
    hits = (gx * gx + gy * gy) < thresh * thresh
    hits &= ~torch.eye(N, dtype=torch.bool, device=apos.device)
    ncoll = hits.sum(-1).to(apos.dtype)
    if mask is not None:
        haus = torch.where(mask, haus, fallback[0])
        ncoll = torch.where(mask[:, None], ncoll, fallback[1])
    return haus, ncoll


def hd_reward_stats_sym(
    apos: torch.Tensor,
    ishape: torch.Tensor,
    *,
    thresh: float,
    mask: Optional[torch.Tensor] = None,
    fallback: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hausdorff [B], per-agent collision count [B, N]) for the
    formation_hd reward with one uniform collision distance ``thresh``.

    ``mask`` [B] bool with ``fallback`` (haus [B], ncoll [B, N]): compute
    only the envs whose mask is True and return the fallback rows for the
    rest.  The kernel's blocks of the other envs copy and return, so the
    call costs little when few envs are masked in, and the host never asks
    whether any are."""
    if (mask is None) != (fallback is None):
        raise ValueError("K2 takes mask and fallback together")
    if not _device.use_kernel(apos):
        return hd_reward_stats_sym_plain(apos, ishape, thresh=thresh, mask=mask, fallback=fallback)
    for name, t in (("apos", apos), ("ishape", ishape)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 2:
            raise ValueError(f"K2 takes float32 [B, N, 2] {name}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"K2 takes a contiguous {name} tensor")
    if ishape.shape != apos.shape or ishape.device != apos.device:
        raise ValueError("K2 takes apos and ishape of one shape on one device")
    B, N, _ = apos.shape
    if N > MAX_AGENTS:
        raise ValueError(f"K2 holds at most {MAX_AGENTS} agents per env, got {N}")
    ptrs = (None, None, None)
    if mask is not None:
        h_fb, nc_fb = fallback
        for name, t, shape, dtype in (("mask", mask, (B,), torch.bool),
                                      ("fallback haus", h_fb, (B,), torch.float32),
                                      ("fallback ncoll", nc_fb, (B, N), torch.float32)):
            if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != apos.device:
                raise ValueError(f"K2 takes a contiguous {dtype} {name} of shape {shape} on the card")
        ptrs = (mask.data_ptr(), h_fb.data_ptr(), nc_fb.data_ptr())
    haus = torch.empty(B, dtype=torch.float32, device=apos.device)
    ncoll = torch.empty(B, N, dtype=torch.float32, device=apos.device)
    with torch.cuda.device(apos.device):
        rc = _build.lib().reward_sym_launch(
            apos.data_ptr(), ishape.data_ptr(), *ptrs, haus.data_ptr(), ncoll.data_ptr(),
            B, N, tile_side(N), _smem_bytes(N), float(thresh) * float(thresh),
            torch.cuda.current_stream(apos.device).cuda_stream,
        )
    _build.check(rc, "reward_sym")
    global launches
    launches += 1
    return haus, ncoll
