"""K4: a whole formation_hd + ezpolicy rollout in one kernel.

The CUDA kernel ``csrc/fused_rollout.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/fused_rollout.py:fused_rollout_hd``.  Its
source note says what bounds it on the H100 and how it is laid out.

Each env runs ``length`` steps of: ezpolicy from the state, point-mass
physics among its n agents (landmarks neither collide nor move, so they drop
out), the shared Hausdorff + velocity + collision reward summed over agents
and steps, and the time-limit auto-reset drawn from a murmur3 counter PRNG
keyed by (seed, step of the call, row, env index).  The PRNG is the JAX
package's bit for bit, so rollouts can be compared across resets.

State is struct-of-arrays over the batch (:class:`SoAState`, ``[rows, B]``
planes).  Landmarks are not carried: after ``pre_obs`` they are always
``ideal_shape + centroid(agents)``, and :func:`soa_to_state` rebuilds them.

:func:`fused_rollout_hd` is the wrapper: a CUDA tensor launches the kernel,
a CPU tensor takes :func:`fused_rollout_hd_plain`, the same function in plain
PyTorch.  ``launches`` counts kernel launches.  The plain version runs the
kernel's operations in the kernel's order, each rounded on its own, so on
the card the two agree bit for bit.  Its means divide by a tensor: PyTorch
on a GPU turns division by a Python scalar into a multiplication by its
reciprocal, which rounds differently.

The kernel takes each env on a group of n lanes of one warp, lane a for
agent a; :func:`launch_plan` gives the envs a warp and the threads a block
by n, :func:`grid_blocks` the grid, and :func:`rollout_schedule_plain`
repeats in numpy which lane holds which (env, agent).
"""

from __future__ import annotations

import functools
from functools import reduce
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ... import _device
from ...core.types import EnvState
from .. import _build

launches = 0

# Agent counts the kernel is instantiated for (a template parameter).
KERNEL_AGENTS = (3, 4, 9)
_M32 = 0xFFFFFFFF
_WARPS = 2  # warps a block (csrc/fused_rollout.cu: WARPS)


class SoAState(NamedTuple):
    """Transposed rollout state: [rows, B] planes."""

    ap: torch.Tensor  # [2n, B] agent positions (x rows, then y rows)
    av: torch.Tensor  # [2n, B] agent velocities
    ishape: torch.Tensor  # [2n, B] centred ideal shape
    ivel: torch.Tensor  # [2, B] ideal velocity
    t: torch.Tensor  # [1, B] int32 step counter


def state_to_soa(state: EnvState) -> SoAState:
    """Batched :class:`EnvState` [B, ...] → :class:`SoAState` planes."""
    n = state.ideal_shape.shape[-2]
    tr = lambda a: torch.cat([a[..., 0].T, a[..., 1].T]).to(torch.float32).contiguous()
    return SoAState(
        ap=tr(state.pos[:, :n]),
        av=tr(state.vel[:, :n]),
        ishape=tr(state.ideal_shape),
        ivel=state.ideal_vel.T.to(torch.float32).contiguous(),
        t=state.t[None, :].to(torch.int32).contiguous(),
    )


def soa_to_state(soa: SoAState, template: EnvState) -> EnvState:
    """:class:`SoAState` → batched :class:`EnvState`, the landmarks rebuilt
    as ``ideal_shape + centroid(agents)``; other fields from ``template``."""
    n = soa.ap.shape[0] // 2
    untr = lambda a: torch.stack([a[:n].T, a[n:].T], dim=-1)  # [2R, B] → [B, R, 2]
    apos = untr(soa.ap)
    ishape = untr(soa.ishape)
    lpos = ishape + apos.mean(1, keepdim=True)
    return template.replace(
        pos=torch.cat([apos, lpos], 1).to(template.pos.dtype),
        vel=torch.cat([untr(soa.av), torch.zeros_like(lpos)], 1).to(template.vel.dtype),
        ideal_shape=ishape.to(template.ideal_shape.dtype),
        ideal_vel=soa.ivel.T.to(template.ideal_vel.dtype),
        t=soa.t[0].to(torch.int32),
    )


# -- the murmur3 counter PRNG, on int64 tensors holding uint32 values -------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32): the product is split into
    16-bit halves so that no intermediate leaves the int64 range."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer of uint32 values held in an int64 tensor."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_pm1(seed: int, it: int, lane: torch.Tensor, rows: int) -> torch.Tensor:
    """Uniform [-1, 1) float32 [rows, B] keyed by (seed, it, row, lane);
    ``lane`` [B] holds the global env indices."""
    row = torch.arange(rows, dtype=torch.int64, device=lane.device)[:, None]
    key = ((seed & _M32) * 2654435761 & _M32) ^ ((it & _M32) * 0x9E3779B9 & _M32)
    ctr = _mul32(row, 0x27D4EB2F) ^ key
    bits = hash_u32((ctr + lane.to(torch.int64)[None, :]) & _M32)
    u01 = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u01 * 2.0 - 1.0


# -- plain version ------------------------------------------------------------

def _mean(rows: List[torch.Tensor], count: torch.Tensor) -> torch.Tensor:
    s = rows[0]
    for r in rows[1:]:
        s = s + r
    return s / count


def _argmin_first(vals: List[torch.Tensor]) -> torch.Tensor:
    """Elementwise argmin over a list; ties go to the lowest index."""
    best, idx = vals[0], torch.zeros_like(vals[0], dtype=torch.int64)
    for i, v in enumerate(vals[1:], start=1):
        take = v < best
        best = torch.where(take, v, best)
        idx = torch.where(take, i, idx)
    return idx


def _argmax_last(vals: List[torch.Tensor]) -> torch.Tensor:
    """Elementwise argmax over a list; ties go to the highest index."""
    best, idx = vals[0], torch.zeros_like(vals[0], dtype=torch.int64)
    for i, v in enumerate(vals[1:], start=1):
        take = v >= best
        best = torch.where(take, v, best)
        idx = torch.where(take, i, idx)
    return idx


def _pick(idx: torch.Tensor, vals: List[torch.Tensor]) -> torch.Tensor:
    out = vals[0]
    for v in range(1, len(vals)):
        out = torch.where(idx == v, vals[v], out)
    return out


def _softplus(z: torch.Tensor) -> torch.Tensor:
    return z.clamp_min(0.0) + torch.log1p(torch.exp(-z.abs()))


def _consts(sensitivity, agent_size, coll_factor, contact_force, contact_margin, damping, dt):
    """The kernel's float arguments, as the plain version uses them."""
    return dict(
        sens=float(sensitivity),
        dmin=float(2.0 * agent_size),
        thresh2=float(2.0 * agent_size * coll_factor) * float(2.0 * agent_size * coll_factor),
        cf=float(contact_force),
        margin=float(contact_margin),
        invk=float(1.0 / contact_margin),
        keep=float(1.0 - damping),
        dt=float(dt),
    )


def fused_rollout_hd_plain(
    soa: SoAState,
    seed: int,
    *,
    length: int,
    ep_len: int,
    n: int,
    sensitivity: float = 5.0,
    agent_size: float = 0.03,
    coll_factor: float = 0.5,
    contact_force: float = 100.0,
    contact_margin: float = 1e-3,
    damping: float = 0.25,
    dt: float = 0.1,
) -> Tuple[SoAState, torch.Tensor]:
    """Plain PyTorch version of K4 (float32); arguments and results as
    :func:`fused_rollout_hd`.  Per-agent quantities are lists of [B]
    tensors, and every loop runs in the kernel's order."""
    c = _consts(sensitivity, agent_size, coll_factor, contact_force, contact_margin, damping, dt)
    B = soa.ap.shape[-1]
    dev = soa.ap.device
    f32 = lambda a: a.to(torch.float32)
    px, py = list(f32(soa.ap[:n])), list(f32(soa.ap[n:]))
    vx, vy = list(f32(soa.av[:n])), list(f32(soa.av[n:]))
    sx, sy = list(f32(soa.ishape[:n])), list(f32(soa.ishape[n:]))
    ivx, ivy = f32(soa.ivel[0]), f32(soa.ivel[1])
    t = soa.t[0].to(torch.int32)
    fn = torch.full((), float(n), dtype=torch.float32, device=dev)
    lane = torch.arange(B, device=dev)
    racc = torch.zeros(B, dtype=torch.float32, device=dev)
    R = range(n)
    for it in range(length):
        # ezpolicy from the state
        mx, my = _mean(px, fn), _mean(py, fn)
        cx, cy = [p - mx for p in px], [p - my for p in py]
        dav = [[torch.sqrt(_sq2(cx[a] - sx[v], cy[a] - sy[v])) for v in R] for a in R]
        closest = [_argmin_first([dav[a][v] for a in R]) for v in R]
        fx, fy = [], []
        for i in R:
            d_self = dav[i]
            far = _argmax_last(d_self)
            masked = [torch.where((closest[v] == i) | (far == v), d_self[v], float("inf")) for v in R]
            pick = _argmin_first(masked)
            ax = torch.clamp(0.5 * (_pick(pick, sx) - cx[i]), -1.0, 1.0)
            ay = torch.clamp(0.5 * (_pick(pick, sy) - cy[i]), -1.0, 1.0)
            # settled: cur rows in the agent's [others, self] order
            others = [a for a in R if a != i] + [i]
            sq = _sq2(sx[0] - cx[others[0]], sy[0] - cy[others[0]])
            for k in range(1, n):
                sq = sq + _sq2(sx[k] - cx[others[k]], sy[k] - cy[others[k]])
            coef = torch.full_like(sq, 0.3).masked_fill(sq < 1e-4, 1.0)
            fx.append(c["sens"] * (ax + ivx * coef))
            fy.append(c["sens"] * (ay + ivy * coef))
        # physics among the agents (mass 1)
        for i in R:
            for j in R:
                if i == j:
                    continue
                dx, dy = px[i] - px[j], py[i] - py[j]
                dist = torch.sqrt(_sq2(dx, dy))
                pen = _softplus((c["dmin"] - dist) * c["invk"]) * c["margin"]
                k = (c["cf"] * pen) / dist.clamp_min(1e-12)
                fx[i] = fx[i] + k * dx
                fy[i] = fy[i] + k * dy
        nvx = [vx[i] * c["keep"] + fx[i] * c["dt"] for i in R]
        nvy = [vy[i] * c["keep"] + fy[i] * c["dt"] for i in R]
        npx = [px[i] + nvx[i] * c["dt"] for i in R]
        npy = [py[i] + nvy[i] * c["dt"] for i in R]
        # reward of the stepped state, summed over the agents
        nmx, nmy = _mean(npx, fn), _mean(npy, fn)
        ncx, ncy = [p - nmx for p in npx], [p - nmy for p in npy]
        d2 = [[torch.sqrt(_sq2(ncx[a] - sx[v], ncy[a] - sy[v])) for v in R] for a in R]
        row_min = [reduce(torch.minimum, d2[a]) for a in R]
        col_min = [reduce(torch.minimum, [d2[a][v] for a in R]) for v in R]
        haus = torch.maximum(reduce(torch.maximum, row_min), reduce(torch.maximum, col_min))
        dvx, dvy = ivx - _mean(nvx, fn), ivy - _mean(nvy, fn)
        shared = -haus - torch.sqrt(_sq2(dvx, dvy))
        ncoll = torch.zeros_like(shared)
        for i in R:
            for j in range(i + 1, n):
                hit = _sq2(npx[i] - npx[j], npy[i] - npy[j]) < c["thresh2"]
                ncoll = ncoll + 2.0 * hit.to(torch.float32)
        racc = racc + (shared * n - ncoll) * n
        # time limit and auto-reset
        nt = t + 1
        done = nt >= ep_len
        rnd = uniform_pm1(seed, it, lane, 4 * n + 2)
        rl = list(rnd[2 * n : 4 * n])
        rlmx, rlmy = _mean(rl[:n], fn), _mean(rl[n:], fn)
        sel = lambda fresh, old: torch.where(done, fresh, old)
        px = [sel(rnd[a], npx[a]) for a in R]
        py = [sel(rnd[n + a], npy[a]) for a in R]
        vx = [sel(torch.zeros_like(v), v) for v in nvx]
        vy = [sel(torch.zeros_like(v), v) for v in nvy]
        sx = [sel(rl[a] - rlmx, sx[a]) for a in R]
        sy = [sel(rl[n + a] - rlmy, sy[a]) for a in R]
        ivx, ivy = sel(rnd[4 * n], ivx), sel(rnd[4 * n + 1], ivy)
        t = torch.where(done, 0, nt).to(torch.int32)
    out = SoAState(
        ap=torch.stack(px + py), av=torch.stack(vx + vy),
        ishape=torch.stack(sx + sy), ivel=torch.stack([ivx, ivy]), t=t[None, :],
    )
    return out, racc


def _sq2(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return dx * dx + dy * dy


# -- launch plan ----------------------------------------------------------------

def launch_plan(n: int) -> Tuple[int, int]:
    """(G, threads) of the kernel at n agents: G = 32 // n envs a warp, each
    on a group of n lanes (10 at n=3, 8 at n=4, 3 at n=9; the other lanes
    idle), and two warps a block.  The launcher checks that it was built
    for the pair."""
    if n not in KERNEL_AGENTS:
        raise ValueError(f"K4 is built for n in {KERNEL_AGENTS}, got n={n}")
    return 32 // n, 32 * _WARPS


def grid_blocks(B: int, per_block: int, per_sm: int, sms: int) -> int:
    """Blocks of a persistent grid over B envs, ``per_block`` envs a block at
    a time (K4: G envs a warp times its warps; K5: a tile): one wave
    (``per_sm`` blocks on each of ``sms`` SMs; beyond it the blocks walk the
    envs), and no block without an env."""
    return max(1, min(-(-B // per_block), sms * per_sm))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(n: int, device: int) -> int:
    """Resident blocks an SM of the kernel for n agents on card ``device``,
    from the occupancy API on the compiled kernel (``fused_rollout_plan``)."""
    G, threads = launch_plan(n)
    with torch.cuda.device(device):
        per_sm = _build.lib().fused_rollout_plan(n, G, threads)
    if per_sm < 1:
        raise RuntimeError(f"fused_rollout_plan(n={n}, G={G}, threads={threads}) returned {per_sm}")
    return per_sm


def rollout_schedule_plain(n: int, B: int, grid: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The kernel's schedule in numpy over B envs with ``grid`` blocks
    (default: one env group a warp).  Warp w = block · warps + warp takes the
    env groups w, w + W, ... (W the warps of the grid) while w·G < B; in
    round r, lane l of warp w holds agent l mod n of env (w + r W)·G + l // n
    if l // n < G and that env is below B, else nothing.

    Returns ``env`` [B] (the groups that ran each env), ``agent`` [B, n] (the
    lanes that held each (env, agent)), and ``lane_env``, ``lane_agent``
    [rounds, grid · threads] (what each thread held in each round, -1 for
    nothing)."""
    G, threads = launch_plan(n)
    warps = threads // 32
    grid = -(-B // (G * warps)) if grid is None else grid
    W = grid * warps
    tid = np.arange(grid * threads)
    w0, lane = tid // 32, tid % 32
    g, a = lane // n, lane % n
    rounds = -(-(-(-B // G)) // W)
    lane_env = np.full((rounds, tid.size), -1, np.int64)
    lane_agent = np.full((rounds, tid.size), -1, np.int64)
    env = np.zeros(B, np.int64)
    agent = np.zeros((B, n), np.int64)
    for r in range(rounds):
        w = w0 + r * W
        b = w * G + g
        live = (w * G < B) & (g < G) & (b < B)
        lane_env[r, live], lane_agent[r, live] = b[live], a[live]
        np.add.at(agent, (b[live], a[live]), 1)
        np.add.at(env, b[live & (a == 0)], 1)
    return dict(env=env, agent=agent, lane_env=lane_env, lane_agent=lane_agent)


# -- wrapper ------------------------------------------------------------------

def fused_rollout_hd(
    soa: SoAState,
    seed: int,
    *,
    length: int,
    ep_len: int,
    n: int,
    sensitivity: float = 5.0,
    agent_size: float = 0.03,
    coll_factor: float = 0.5,
    contact_force: float = 100.0,
    contact_margin: float = 1e-3,
    damping: float = 0.25,
    dt: float = 0.1,
) -> Tuple[SoAState, torch.Tensor]:
    """Run ``length`` fused env steps of every env.  Returns
    ``(SoAState', reward_sum [B])``, where reward_sum is each env's reward
    summed over steps and agents (the shared-reward broadcast included).
    On the card, n must be one of :data:`KERNEL_AGENTS`; the launch follows
    :func:`launch_plan` and :func:`grid_blocks`."""
    kw = dict(length=length, ep_len=ep_len, n=n, sensitivity=sensitivity, agent_size=agent_size,
              coll_factor=coll_factor, contact_force=contact_force,
              contact_margin=contact_margin, damping=damping, dt=dt)
    if not _device.use_kernel(soa.ap):
        return fused_rollout_hd_plain(soa, seed, **kw)
    G, threads = launch_plan(n)
    B = soa.ap.shape[-1]
    shapes = dict(ap=(2 * n, B), av=(2 * n, B), ishape=(2 * n, B), ivel=(2, B), t=(1, B))
    for name, shape in shapes.items():
        t = getattr(soa, name)
        dtype = torch.int32 if name == "t" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != soa.ap.device:
            raise ValueError(f"K4 takes a contiguous {dtype} {name} of shape {shape} on the card, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = SoAState(*(torch.empty_like(t) for t in soa))
    rew = torch.empty(B, dtype=torch.float32, device=soa.ap.device)
    c = _consts(sensitivity, agent_size, coll_factor, contact_force, contact_margin, damping, dt)
    dev = soa.ap.device
    grid = grid_blocks(B, G * (threads // 32), _blocks_per_sm(n, dev.index),
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    rc = _build.lib().fused_rollout_launch(
        *(t.data_ptr() for t in soa), *(t.data_ptr() for t in out), rew.data_ptr(),
        B, n, int(length), int(ep_len), G, threads, grid, int(seed) & _M32,
        c["sens"], c["dmin"], c["thresh2"], c["cf"], c["margin"], c["invk"], c["keep"], c["dt"],
        torch.cuda.current_stream(soa.ap.device).cuda_stream,
    )
    _build.check(rc, "fused_rollout")
    global launches
    launches += 1
    return out, rew
