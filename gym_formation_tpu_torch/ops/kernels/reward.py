"""K7: Hausdorff and collision statistics of the formation_hd reward, in
one sweep (the row-major kernel of ``set_reward_impl("rowmajor")``).

The CUDA kernel ``csrc/reward.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/reward.py:hd_reward_stats_batched``.  Its
source note says what bounds it on the H100 and how it is laid out.  It
computes K2's function with K2's register tiles (``hd_stats_tiles``), and
this wrapper picks the tile side and the shared memory by K2's rules, so K7
and K2 give the same bits.  The plain version counts the full N x N sweep
minus the self hit instead of K2's ``j != i``, with the same result.

:func:`hd_reward_stats_batched` is the wrapper: a CUDA tensor launches the
kernel, a CPU tensor takes :func:`hd_reward_stats_batched_plain`, the same
function in plain PyTorch.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ... import _device
from .. import _build
from .reward_sym import MAX_AGENTS, _smem_bytes, tile_side

launches = 0


def hd_reward_stats_batched_plain(
    apos: torch.Tensor, ishape: torch.Tensor, *, thresh: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7.  ``apos`` [B, N, 2] raw agent positions,
    ``ishape`` [B, N, 2] centred ideal shape → (haus [B], ncoll [B, N]).

    Squared distances feed the min/max reductions and one sqrt is taken on
    the reduced value; the collision count is the number of agents j (self
    included) with d² < thresh² on the raw positions, minus one, each square
    rounded on its own (no fused multiply-add)."""
    c = apos - apos.mean(-2, keepdim=True)
    dx = c[:, :, None, 0] - ishape[:, None, :, 0]  # [B, agent, vertex]
    dy = c[:, :, None, 1] - ishape[:, None, :, 1]
    d2 = dx * dx + dy * dy
    haus = torch.sqrt(torch.maximum(d2.amin(2).amax(1), d2.amin(1).amax(1)))
    gx = apos[:, :, None, 0] - apos[:, None, :, 0]  # [B, agent, agent]
    gy = apos[:, :, None, 1] - apos[:, None, :, 1]
    hits = (gx * gx + gy * gy) < thresh * thresh
    return haus, (hits.sum(-1) - 1).to(apos.dtype)


def hd_reward_stats_batched(
    apos: torch.Tensor, ishape: torch.Tensor, *, thresh: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hausdorff [B], per-agent collision count [B, N]) for the
    formation_hd reward with one uniform collision distance ``thresh``."""
    if not _device.use_kernel(apos):
        return hd_reward_stats_batched_plain(apos, ishape, thresh=thresh)
    for name, t in (("apos", apos), ("ishape", ishape)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 2:
            raise ValueError(f"K7 takes float32 [B, N, 2] {name}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"K7 takes a contiguous {name} tensor")
    if ishape.shape != apos.shape or ishape.device != apos.device:
        raise ValueError("K7 takes apos and ishape of one shape on one device")
    B, N, _ = apos.shape
    if N > MAX_AGENTS:
        raise ValueError(f"K7 holds at most {MAX_AGENTS} agents per env, got {N}")
    haus = torch.empty(B, dtype=torch.float32, device=apos.device)
    ncoll = torch.empty(B, N, dtype=torch.float32, device=apos.device)
    rc = _build.lib().reward_launch(
        apos.data_ptr(), ishape.data_ptr(), haus.data_ptr(), ncoll.data_ptr(),
        B, N, tile_side(N), _smem_bytes(N), float(thresh) * float(thresh),
        torch.cuda.current_stream(apos.device).cuda_stream,
    )
    _build.check(rc, "reward")
    global launches
    launches += 1
    return haus, ncoll
