"""The fused rollout's state glue and auto-reset of one step, in one launch.

The CUDA kernel ``csrc/step_reset.cu`` replaces no TPU kernel: it does in
one launch what the fused rollout
(:func:`~gym_formation_tpu_torch.env.rollout_statepolicy_fused`) did in
some 40 small PyTorch launches a step around K3, the work XLA fuses into
the JAX package's step.  Its source note says what bounds it on the H100
and how it is laid out.

:func:`step_reset` is the wrapper: a CUDA tensor launches the kernel, a
CPU tensor takes :func:`step_reset_plain`, the same function in plain
PyTorch (in the dtype of the state).  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ... import _device
from .. import _build

launches = 0

_SMEM_MAX = 232448  # bytes of shared memory a block may use on the H100, opted in beyond 48 KB
_THREADS = 256


def launch_plan(n: int) -> Tuple[int, int]:
    """(G, envs): the lanes of one warp that take an env of ``n`` agents,
    the smallest power of two >= n and at most 32, and the envs of a block
    of at most 256 threads, as many as the shared memory holds (n float2 an
    env)."""
    G = min(32, 1 << max(0, n - 1).bit_length())
    envs = _THREADS // G
    while envs * G > 32 and envs * n * 8 > _SMEM_MAX:
        envs //= 2
    if envs * n * 8 > _SMEM_MAX:
        raise ValueError(f"step_reset does not hold n={n} agents in the card's shared memory")
    return G, envs


def bytes_moved(n: int, B: int, resets: int) -> int:
    """The bytes a launch must move, each input read and each output written
    once, for ``B`` envs of ``n`` agents of which ``resets`` reset: a row
    that carries on reads 10 n + 3 floats (npos, nvel, the landmarks and
    their velocities, the shape; ivel, t) and a row that resets 6 n + 5
    (nvel, the agent and landmark draws; ivel, t, the ivel draw); every row
    writes 10 n + 4 floats (pos, vel, shape; ivel, t, velterm) and a byte
    (done)."""
    carry, fresh = B - resets, resets
    reads = carry * (10 * n + 3) + fresh * (6 * n + 5)
    return 4 * (reads + B * (10 * n + 4)) + B


def step_reset_plain(
    pos: torch.Tensor,
    vel: torch.Tensor,
    ishape: torch.Tensor,
    ivel: torch.Tensor,
    t: torch.Tensor,
    npos: torch.Tensor,
    nvel: torch.Tensor,
    ua: torch.Tensor,
    ul: torch.Tensor,
    uv: torch.Tensor,
    *,
    row0: int,
    world_length: int,
):
    """Plain PyTorch version of the kernel, in the dtype of the state;
    arguments and results as :func:`step_reset`.  The stepped state is the
    fused rollout's former PyTorch glue (the agents replaced, then
    ``FormationHDScenario.pre_obs``), the fresh one
    ``FormationEnv.reset_state`` on the drawn rows, and the pick
    ``env._select``'s."""
    B, n = npos.shape[:2]
    apos, avel = npos.to(pos.dtype), nvel.to(vel.dtype)
    lpos = pos[:, n:]
    lpos = lpos + (apos.mean(1, keepdim=True) - lpos.mean(1, keepdim=True))
    dv = ivel - nvel.mean(1)
    velterm = -torch.sqrt((dv * dv).sum(-1))
    t1 = t + 1
    done = t1 >= world_length
    fa, fl, fv = (u[row0 : row0 + B] * 2.0 - 1.0 for u in (ua, ul, uv))
    fshape = fl - fl.mean(1, keepdim=True)
    fl = fl + (fa.mean(1, keepdim=True) - fl.mean(1, keepdim=True))
    pick = lambda x, y: torch.where(done.reshape((-1,) + (1,) * (y.dim() - 1)), x, y)
    return (
        torch.cat([pick(fa, apos), pick(fl, lpos)], 1),
        torch.where(done[:, None, None], 0.0, torch.cat([avel, vel[:, n:]], 1)),
        pick(fshape, ishape),
        pick(fv, ivel),
        torch.where(done, 0, t1),
        velterm,
        done,
    )


def step_reset(
    pos: torch.Tensor,
    vel: torch.Tensor,
    ishape: torch.Tensor,
    ivel: torch.Tensor,
    t: torch.Tensor,
    npos: torch.Tensor,
    nvel: torch.Tensor,
    ua: torch.Tensor,
    ul: torch.Tensor,
    uv: torch.Tensor,
    *,
    row0: int,
    world_length: int,
):
    """One step's state glue and auto-reset of the fused formation_hd
    rollout.

    Args:
      pos, vel: [B, 2n, 2] the state before the step (agents, then as many
        landmarks); its agents are replaced by ``npos``, ``nvel``.
      ishape: [B, n, 2] centred ideal shape; ivel: [B, 2] ideal velocity;
        t: [B] int32 episode steps.
      npos, nvel: [B, n, 2] the agents after the step's physics (K3's).
      ua, ul: [Bg, n, 2] and uv: [Bg, 2], the auto-reset's raw U(0, 1)
        draws of agents, landmarks and ideal velocity over the global batch.
      row0: the global row of env 0 (the rank's offset under a mesh).
      world_length: the episode length.

    Returns ``(pos, vel, ishape, ivel, t, velterm [B], done [B] bool)``:
    the next state, landmarks recentred onto the agents' centroid, with a
    fresh episode where ``t + 1 >= world_length``, the step's velocity term
    ``-|ivel - mean(nvel)|`` and that done flag.
    """
    B, n = npos.shape[:2]
    if not 0 <= row0 <= ua.shape[0] - B:
        raise ValueError(f"step_reset: rows [{row0}, {row0 + B}) outside the {ua.shape[0]} drawn")
    if not _device.use_kernel(pos):
        return step_reset_plain(pos, vel, ishape, ivel, t, npos, nvel, ua, ul, uv,
                                row0=row0, world_length=world_length)
    Bg = ua.shape[0]
    for name, x, shape, dtype in (
        ("pos", pos, (B, 2 * n, 2), torch.float32), ("vel", vel, (B, 2 * n, 2), torch.float32),
        ("ishape", ishape, (B, n, 2), torch.float32), ("ivel", ivel, (B, 2), torch.float32),
        ("t", t, (B,), torch.int32), ("npos", npos, (B, n, 2), torch.float32),
        ("nvel", nvel, (B, n, 2), torch.float32), ("ua", ua, (Bg, n, 2), torch.float32),
        ("ul", ul, (Bg, n, 2), torch.float32), ("uv", uv, (Bg, 2), torch.float32),
    ):
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != pos.device or not x.is_contiguous():
            raise ValueError(f"step_reset takes a contiguous {dtype} {name} of shape {shape} on the card, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    G, envs = launch_plan(n)
    opos, ovel = torch.empty_like(pos), torch.empty_like(vel)
    oishape, oivel, ot = torch.empty_like(ishape), torch.empty_like(ivel), torch.empty_like(t)
    velterm = torch.empty(B, dtype=torch.float32, device=pos.device)
    done = torch.empty(B, dtype=torch.bool, device=pos.device)
    with torch.cuda.device(pos.device):
        rc = _build.lib().step_reset_launch(
            pos.data_ptr(), vel.data_ptr(), ishape.data_ptr(), ivel.data_ptr(), t.data_ptr(),
            npos.data_ptr(), nvel.data_ptr(), ua.data_ptr(), ul.data_ptr(), uv.data_ptr(),
            opos.data_ptr(), ovel.data_ptr(), oishape.data_ptr(), oivel.data_ptr(), ot.data_ptr(),
            velterm.data_ptr(), done.data_ptr(), B, n, G, envs, row0, int(world_length),
            torch.cuda.current_stream(pos.device).cuda_stream,
        )
    _build.check(rc, "step_reset")
    global launches
    launches += 1
    return opos, ovel, oishape, oivel, ot, velterm, done
