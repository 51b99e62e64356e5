"""K5: the whole MAPPO collection on formation_hd in one kernel.

The CUDA kernel ``csrc/fused_collect.cu`` replaces the TPU kernel
``gym_formation_tpu/ops/pallas/fused_collect.py:fused_collect_hd``.  Its
source note says what bounds it on the H100 and how it is laid out.

Each of ``length`` steps of each env: build the n agents' observations from
the state, run the shared 64-64 GaussianActor on each and the centralized
ValueCritic on their concatenation, sample the actions by Box–Muller from the
murmur3 counter PRNG, step the point-mass physics among the agents, take the
shared Hausdorff + velocity + collision reward, and auto-reset at the time
limit.  The trajectory holds what the PPO update reads: obs, action, logp,
value, reward, done.  The random bits are the JAX kernel's, bit for bit:
each draw is keyed by the env's index, plus ``env_offset`` where a launch
holds a data-parallel rank's envs (its first env's global index), so that a
rank draws what one launch over the whole batch draws for those envs.

:func:`fused_collect_hd` is the wrapper: a CUDA tensor launches the kernel, a
CPU tensor takes :func:`fused_collect_hd_plain`.  ``launches`` counts kernel
launches.  The plain version runs the kernel's operations in the kernel's
order, each rounded on its own, the layer products included (a running sum
over the inputs, one multiply and one add per input), so on the card the two
agree bit for bit.

The kernel takes the envs in tiles of E, one tile a block at a time, in a
persistent grid; :func:`launch_plan` gives E and the shared bytes by n,
:func:`collect_schedule_plain` repeats in numpy which thread computes what.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import _device
from .. import _build
from .fused_rollout import _M32, SoAState, _consts, _mean, _mul32, _softplus, _sq2, grid_blocks, hash_u32

launches = 0

# Agent counts the kernel is instantiated for (a template parameter), and the
# hidden widths it takes.
KERNEL_AGENTS = (3, 4, 9)
HIDDEN = 64
_LOG_2PI = math.log(2.0 * math.pi)

# The kernel's block and shared-memory layout (csrc/fused_collect.cu)
_THREADS = 256
_WS = 68  # row stride of a transposed weight matrix, floats
_HS = 68  # row stride of a hidden activation, floats
_SMEM_MAX = 232448  # bytes of shared memory a block may use on the H100, opted in beyond 48 KB


def smem_bytes(n: int, E: int) -> int:
    """Shared memory of a block at n agents and E envs a tile: the weights
    (four matrices transposed to rows of ``_WS`` floats, the biases and
    heads) and the tile's activations (obs, two hidden layers of each
    network, two steps' normals, the actions)."""
    do, dc, a, H = 6 * n, 6 * n * n, 2 * n, HIDDEN
    weights = (do + H + dc + H) * _WS + 7 * H + 4
    tile = E * (dc + 2 * n * _HS + 2 * _HS + 3 * a)
    return 4 * (weights + tile)


def launch_plan(n: int) -> Tuple[int, int]:
    """(E, shared bytes) of the kernel at n agents: E, the envs of a tile, is
    the largest of 16, 8, 4, 2, 1 whose block fits the card's shared memory
    (n=3: 16, n=4: 16, n=9: 4); the launcher checks that it was built for
    the pair."""
    E = next((E for E in (16, 8, 4, 2, 1) if smem_bytes(n, E) <= _SMEM_MAX), None)
    if E is None:
        raise ValueError(f"K5's weights at n={n} do not fit a block's shared memory")
    return E, smem_bytes(n, E)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(n: int, device: int) -> int:
    """Resident blocks an SM of the kernel for n agents on card ``device``,
    from the occupancy API on the compiled kernel (``fused_collect_plan``)."""
    E, smem = launch_plan(n)
    with torch.cuda.device(device):
        per_sm = _build.lib().fused_collect_plan(n, E, smem)
    if per_sm < 1:
        raise RuntimeError(f"fused_collect_plan(n={n}, E={E}, smem={smem}) returned {per_sm}")
    return per_sm


def collect_schedule_plain(n: int, E: int, B: int, G: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The kernel's schedule in numpy, counting how often each piece of work
    is done in one step of a launch over B envs with G blocks (default: one
    tile a block).  Block g takes the tiles of envs b0 = (g + k G) E ..
    b0 + E - 1, cut at B; in a tile, thread tid < E runs env b0 + tid, thread
    (ug, rg) = (tid % 16, tid / 16) computes units 4 ug .. 4 ug + 3 of the
    rows rg + 16 j < rows of each layer (j < ceil(rows / 16)), and thread
    tid takes the head outputs tid, tid + 256, ... below E (2n + 1).

    Returns ``env`` [B] (the envs run), ``actor1``, ``actor2`` [B n, 64]
    (actor outputs per env-agent row), ``critic1``, ``critic2`` [B, 64],
    ``mean`` [B, n, 2] and ``value`` [B] (head outputs), each counting the
    computations whose results reach the trajectory."""
    G = -(-B // E) if G is None else G
    A, H = 2 * n, HIDDEN
    tid = np.arange(_THREADS)
    ug, rg = tid % 16, tid // 16
    per_row = dict(actor1=n, actor2=n, critic1=1, critic2=1)  # rows of a layer an env
    out = {k: np.zeros((B * r, H), np.int64) for k, r in per_row.items()}
    out.update(env=np.zeros(B, np.int64), mean=np.zeros(B * A, np.int64), value=np.zeros(B, np.int64))
    for g in range(G):
        for b0 in range(g * E, B, G * E):
            nv = min(E, B - b0)
            np.add.at(out["env"], b0 + tid[tid < nv], 1)
            for name, m in per_row.items():
                for j in range(-(-E * m // 16)):
                    r = rg + 16 * j
                    keep = (r < E * m) & (r < nv * m)  # a row of the tile, of an env in the batch
                    for c in range(4):
                        np.add.at(out[name], (b0 * m + r[keep], 4 * ug[keep] + c), 1)
            t = np.concatenate([tid + _THREADS * k for k in range(-(-E * (A + 1) // _THREADS))])
            t = t[t < E * (A + 1)]
            mean, val = t[t < E * A], t[t >= E * A] - E * A
            np.add.at(out["mean"], b0 * A + mean[mean < nv * A], 1)
            np.add.at(out["value"], b0 + val[val < nv], 1)
    out["mean"] = out["mean"].reshape(B, n, 2)
    return out


def actor_planes(actor) -> Tuple[torch.Tensor, ...]:
    """GaussianActor → kernel operands ``(w1 [64, do], b1 [64], w2 [64, 64],
    b2, w3 [2, 64], b3 [2], log_std [2])``, float32, weights ``[out, in]``.
    The log-std is soft-bounded here, as the actor's forward bounds it."""
    f = lambda t: t.detach().to(torch.float32).contiguous()
    l1, l2 = actor.mlp.layers
    return (f(l1.weight), f(l1.bias), f(l2.weight), f(l2.bias),
            f(actor.head.weight), f(actor.head.bias), f(actor.bounded_log_std()))


def critic_planes(critic) -> Tuple[torch.Tensor, ...]:
    """ValueCritic → kernel operands ``(w1 [64, n·do], b1, w2, b2, w3 [1, 64],
    b3 [1])``."""
    f = lambda t: t.detach().to(torch.float32).contiguous()
    l1, l2 = critic.mlp.layers
    return (f(l1.weight), f(l1.bias), f(l2.weight), f(l2.bias), f(critic.head.weight), f(critic.head.bias))


def uniform01(seed: int, it: int, lane: torch.Tensor, rows: int, salt: int) -> torch.Tensor:
    """Uniform (0, 1] float32 [rows, B] keyed by (seed, it, row, lane, salt),
    the JAX kernel's ``_uniform01``."""
    row = torch.arange(rows, dtype=torch.int64, device=lane.device)[:, None]
    key = ((seed & _M32) * 2654435761 & _M32) ^ ((it & _M32) * 0x9E3779B9 & _M32)
    ctr = _mul32((row + salt * 131) & _M32, 0x27D4EB2F) ^ key
    bits = hash_u32((ctr + lane.to(torch.int64)[None, :]) & _M32)
    return 1.0 - (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def normal(seed: int, it: int, lane: torch.Tensor, rows: int, salt: int) -> torch.Tensor:
    """Standard normals [rows, B]: Box–Muller over the uniforms of ``salt``
    and ``salt + 7``."""
    u1 = uniform01(seed, it, lane, rows, salt)
    u2 = uniform01(seed, it, lane, rows, salt + 7)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos((2.0 * torch.tensor(math.pi, dtype=torch.float32)).to(u2.device) * u2)


def _dense(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w [out, in] @ x [..., in, B] + b`` as the kernel sums it: a running
    sum over the inputs in order, then the bias."""
    acc = w[:, 0, None] * x[..., 0:1, :]
    for k in range(1, w.shape[1]):
        acc = acc + w[:, k, None] * x[..., k : k + 1, :]
    return acc + b[:, None]


def _observations(px, py, vx, vy, sx, sy, ivx, ivy, n) -> torch.Tensor:
    """[n, 6n, B]: per agent i, vel, then p_j − p_i for j ≠ i, then 2(n−1)
    zeros (silent agents), the flat ideal shape and the ideal velocity."""
    zero = torch.zeros_like(px[0])
    flat = [r for v in range(n) for r in (sx[v], sy[v])]
    agents = []
    for i in range(n):
        rows = [vx[i], vy[i]]
        for j in range(n):
            if j != i:
                rows += [px[j] - px[i], py[j] - py[i]]
        rows += [zero] * (2 * (n - 1)) + flat + [ivx, ivy]
        agents.append(torch.stack(rows))
    return torch.stack(agents)


def fused_collect_hd_plain(
    soa: SoAState,
    actor_ops: Tuple[torch.Tensor, ...],
    critic_ops: Tuple[torch.Tensor, ...],
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
    env_offset: int = 0,
) -> Tuple[SoAState, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of K5 (float32); arguments and results as
    :func:`fused_collect_hd`."""
    c = _consts(sensitivity, agent_size, coll_factor, contact_force, contact_margin, damping, dt)
    B, dev = soa.ap.shape[-1], soa.ap.device
    f32 = lambda a: a.to(torch.float32)
    aw1, ab1, aw2, ab2, aw3, ab3, als = (f32(t) for t in actor_ops)
    cw1, cb1, cw2, cb2, cw3, cb3 = (f32(t) for t in critic_ops)
    std = torch.exp(als)
    ls_sum = als[0]
    for a in range(1, als.shape[0]):
        ls_sum = ls_sum + als[a]
    px, py = list(f32(soa.ap[:n])), list(f32(soa.ap[n:]))
    vx, vy = list(f32(soa.av[:n])), list(f32(soa.av[n:]))
    sx, sy = list(f32(soa.ishape[:n])), list(f32(soa.ishape[n:]))
    ivx, ivy = f32(soa.ivel[0]), f32(soa.ivel[1])
    t = soa.t[0].to(torch.int32)
    fn = torch.full((), float(n), dtype=torch.float32, device=dev)
    lane = torch.arange(env_offset, env_offset + B, device=dev)
    R = range(n)
    traj: Dict[str, List[torch.Tensor]] = {k: [] for k in ("obs", "action", "logp", "value", "reward", "done")}
    for it in range(length):
        obs = _observations(px, py, vx, vy, sx, sy, ivx, ivy, n)  # [n, 6n, B]
        # actor and sampling
        h = torch.relu(_dense(aw1, ab1, obs))
        h = torch.relu(_dense(aw2, ab2, h))
        mean = _dense(aw3, ab3, h)  # [n, 2, B]
        z = normal(seed, it, lane, 2 * n, salt=1).reshape(n, 2, B)
        act = mean + std[:, None] * z
        logp = (-0.5 * (z[:, 0] * z[:, 0] + z[:, 1] * z[:, 1]) - ls_sum) - _LOG_2PI  # [n, B]
        # critic on the concatenated observations
        k = torch.relu(_dense(cw1, cb1, obs.reshape(n * 6 * n, B)))
        k = torch.relu(_dense(cw2, cb2, k))
        value = _dense(cw3, cb3, k)[0]
        # physics among the agents (mass 1)
        fx = [c["sens"] * act[i, 0] for i in R]
        fy = [c["sens"] * act[i, 1] for i in R]
        for i in R:
            for j in R:
                if i == j:
                    continue
                dx, dy = px[i] - px[j], py[i] - py[j]
                dist = torch.sqrt(_sq2(dx, dy))
                pen = _softplus((c["dmin"] - dist) * c["invk"]) * c["margin"]
                kf = (c["cf"] * pen) / dist.clamp_min(1e-12)
                fx[i] = fx[i] + kf * dx
                fy[i] = fy[i] + kf * dy
        nvx = [vx[i] * c["keep"] + fx[i] * c["dt"] for i in R]
        nvy = [vy[i] * c["keep"] + fy[i] * c["dt"] for i in R]
        npx = [px[i] + nvx[i] * c["dt"] for i in R]
        npy = [py[i] + nvy[i] * c["dt"] for i in R]
        # env reward of the stepped state: n·shared − collision count
        nmx, nmy = _mean(npx, fn), _mean(npy, fn)
        ncx, ncy = [p - nmx for p in npx], [p - nmy for p in npy]
        d = [[torch.sqrt(_sq2(ncx[a] - sx[v], ncy[a] - sy[v])) for v in R] for a in R]
        rmax = cmax = None
        for a in R:
            rmin = d[a][0]
            for v in range(1, n):
                rmin = torch.minimum(rmin, d[a][v])
            rmax = rmin if rmax is None else torch.maximum(rmax, rmin)
        for v in R:
            cmin = d[0][v]
            for a in range(1, n):
                cmin = torch.minimum(cmin, d[a][v])
            cmax = cmin if cmax is None else torch.maximum(cmax, cmin)
        haus = torch.maximum(rmax, cmax)
        dvx, dvy = ivx - _mean(nvx, fn), ivy - _mean(nvy, fn)
        shared = -haus - torch.sqrt(_sq2(dvx, dvy))
        ncoll = torch.zeros_like(shared)
        for i in R:
            for j in range(i + 1, n):
                hit = _sq2(npx[i] - npx[j], npy[i] - npy[j]) < c["thresh2"]
                ncoll = ncoll + 2.0 * hit.to(torch.float32)
        reward = shared * fn - ncoll
        # time limit and auto-reset
        nt = t + 1
        done = nt >= ep_len
        u = uniform01(seed, it, lane, 4 * n + 2, salt=3) * 2.0 - 1.0
        rl = list(u[2 * n : 4 * n])
        rlmx, rlmy = _mean(rl[:n], fn), _mean(rl[n:], fn)
        sel = lambda fresh, old: torch.where(done, fresh, old)
        px = [sel(u[a], npx[a]) for a in R]
        py = [sel(u[n + a], npy[a]) for a in R]
        vx = [sel(torch.zeros_like(v), v) for v in nvx]
        vy = [sel(torch.zeros_like(v), v) for v in nvy]
        sx = [sel(rl[a] - rlmx, sx[a]) for a in R]
        sy = [sel(rl[n + a] - rlmy, sy[a]) for a in R]
        ivx, ivy = sel(u[4 * n], ivx), sel(u[4 * n + 1], ivy)
        t = torch.where(done, 0, nt).to(torch.int32)
        for key, val in (("obs", obs.permute(2, 0, 1)), ("action", act.permute(2, 0, 1)),
                         ("logp", logp.T), ("value", value), ("reward", reward), ("done", done)):
            traj[key].append(val)
    out = SoAState(
        ap=torch.stack(px + py), av=torch.stack(vx + vy),
        ishape=torch.stack(sx + sy), ivel=torch.stack([ivx, ivy]), t=t[None, :],
    )
    return out, {k: torch.stack(v) for k, v in traj.items()}


def fused_collect_hd(
    soa: SoAState,
    actor_ops: Tuple[torch.Tensor, ...],
    critic_ops: Tuple[torch.Tensor, ...],
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
    env_offset: int = 0,
) -> Tuple[SoAState, Dict[str, torch.Tensor]]:
    """Run ``length`` fused collection steps of every env.

    ``soa`` holds the state planes, ``actor_ops`` / ``critic_ops`` the
    operands of :func:`actor_planes` / :func:`critic_planes`, ``seed`` keys
    the counter PRNG, ``env_offset`` is the global index of env 0 (a
    data-parallel rank's first env; the draws of env b are keyed by
    ``env_offset + b``).  Returns ``(SoAState', traj)`` with traj batch-second:
    obs [T, B, n, 6n], action [T, B, n, 2], logp [T, B, n], value and reward
    [T, B] (float32), done [T, B] (bool).  On the card, n must be one of
    :data:`KERNEL_AGENTS` and the hidden widths 64."""
    kw = dict(length=length, ep_len=ep_len, n=n, sensitivity=sensitivity, agent_size=agent_size,
              coll_factor=coll_factor, contact_force=contact_force,
              contact_margin=contact_margin, damping=damping, dt=dt, env_offset=env_offset)
    if not _device.use_kernel(soa.ap):
        return fused_collect_hd_plain(soa, actor_ops, critic_ops, seed, **kw)
    if n not in KERNEL_AGENTS:
        raise ValueError(f"K5 is built for n in {KERNEL_AGENTS}, got n={n}")
    B, T, do, H = soa.ap.shape[-1], int(length), 6 * n, HIDDEN
    dev = soa.ap.device
    expect = dict(ap=((2 * n, B), torch.float32), av=((2 * n, B), torch.float32),
                  ishape=((2 * n, B), torch.float32), ivel=((2, B), torch.float32), t=((1, B), torch.int32))
    ops_shapes = [(H, do), (H,), (H, H), (H,), (2, H), (2,), (2,),
                  (H, n * do), (H,), (H, H), (H,), (1, H), (1,)]
    named = [(name, getattr(soa, name), *expect[name]) for name in expect]
    named += [(f"weight operand {i}", w, s, torch.float32)
              for i, (w, s) in enumerate(zip(list(actor_ops) + list(critic_ops), ops_shapes))]
    for name, x, shape, dtype in named:
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"K5 takes a contiguous {dtype} {name} of shape {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    out = SoAState(*(torch.empty_like(x) for x in soa))
    traj = dict(
        obs=torch.empty((T, B, n, do), dtype=torch.float32, device=dev),
        action=torch.empty((T, B, n, 2), dtype=torch.float32, device=dev),
        logp=torch.empty((T, B, n), dtype=torch.float32, device=dev),
        value=torch.empty((T, B), dtype=torch.float32, device=dev),
        reward=torch.empty((T, B), dtype=torch.float32, device=dev),
        done=torch.empty((T, B), dtype=torch.bool, device=dev),
    )
    c = _consts(sensitivity, agent_size, coll_factor, contact_force, contact_margin, damping, dt)
    E, smem = launch_plan(n)
    G = grid_blocks(B, E, _blocks_per_sm(n, dev.index), torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        rc = _build.lib().fused_collect_launch(
            *(x.data_ptr() for x in soa), *(w.data_ptr() for w in actor_ops), *(w.data_ptr() for w in critic_ops),
            *(x.data_ptr() for x in out),
            *(traj[k].data_ptr() for k in ("obs", "action", "logp", "value", "reward", "done")),
            B, n, T, int(ep_len), E, G, smem, int(seed) & _M32, int(env_offset) & _M32,
            c["sens"], c["dmin"], c["thresh2"], c["cf"], c["margin"], c["invk"], c["keep"], c["dt"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "fused_collect")
    global launches
    launches += 1
    return out, traj
