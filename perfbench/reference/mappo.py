"""MAPPO in plain torch: the reference's networks, collection, GAE with the
running value normaliser, the clipped PPO loss and the global-norm clipped
Adam (Yu et al., "The Surprising Effectiveness of PPO in Cooperative
Multi-Agent Games", arXiv:2103.01955, with the JAX package's defaults).

Parameters are a dict of tensors named as the program's modules name them
(``actor.mlp.layers.0.weight`` [out, in], ...), so the benchmark hands both
sides the same weights by name.  The actor is a diagonal Gaussian over a
64-64 ReLU trunk on the 6N-wide formation_hd observation
``[vel_i | p_k − p_i for k ≠ i | 2(N−1) zeros | ideal shape | ideal
velocity]``; the centralized critic reads the N observations concatenated.
At large N the first layers are evaluated from the state without building
the observation (``factorized``); the algebra is exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from . import formation as F
from . import prng

LOG_2PI = math.log(2.0 * math.pi)
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PPO:
    lr: float = 7e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ppo_epochs: int = 10
    entropy_coef: float = 0.01
    value_coef: float = 1.0
    max_grad_norm: float = 10.0
    rollout_len: int = 25
    huber_delta: float = 10.0
    adam_eps: float = 1e-5


def soft_bound(x, lo: float, hi: float):
    sp = torch.nn.functional.softplus
    return hi - sp(hi - (lo + sp(x - lo)))


def _dense(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


def _trunk_tail(p: Params, net: str, h1pre: torch.Tensor) -> torch.Tensor:
    h = torch.relu(h1pre)
    return torch.relu(_dense(p, f"{net}.mlp.layers.1", h))


# -- the observation and the dense first layers -----------------------------------

def observation(apos, avel, ishape, ivel) -> torch.Tensor:
    """[..., N, 6N] formation_hd observations of silent agents."""
    *lead, n, _ = apos.shape
    rel = apos[..., None, :, :] - apos[..., :, None, :]  # [..., i, k, 2] = p_k − p_i
    keep = ~torch.eye(n, dtype=torch.bool, device=apos.device)
    rel = rel[..., keep, :].reshape(*lead, n, 2 * (n - 1))
    zeros = apos.new_zeros(*lead, n, 2 * (n - 1))
    shape = ishape.reshape(*lead, 1, 2 * n).expand(*lead, n, 2 * n)
    iv = ivel[..., None, :].expand(*lead, n, 2)
    return torch.cat([avel, rel, zeros, shape, iv], -1)


# -- the factorized first layers -------------------------------------------------

def _actor_h1_factorized(W: torch.Tensor, b: torch.Tensor, apos, avel, ishape, ivel):
    """obs_i · W + b from the state; W [6N, H]."""
    n = apos.shape[-2]
    Wr = W[2: 2 * n].reshape(n - 1, 2, -1)  # slot j of the relative block
    # neighbour k sits in slot k when k < i, slot k − 1 when k > i
    low = torch.einsum("...kc,kch->...kh", apos[..., : n - 1, :], Wr)  # p_k·Wr[k]
    high = torch.einsum("...kc,kch->...kh", apos[..., 1:, :], Wr)  # p_k·Wr[k−1]
    z = torch.zeros_like(low[..., :1, :])
    before = torch.cat([z, torch.cumsum(low, -2)], -2)  # Σ_{k<i}
    rc = torch.flip(torch.cumsum(torch.flip(high, [-2]), -2), [-2])  # Σ_{k≥m} of high[m] = p_{m+1}
    after = torch.cat([rc, z], -2)  # Σ_{k>i}
    U = Wr.sum(0)
    own = avel @ W[0:2] - apos @ U
    shared = ishape.flatten(-2) @ W[4 * n - 2: 6 * n - 2] + ivel @ W[6 * n - 2:] + b
    return own + before + after + shared[..., None, :]


def _critic_h1_factorized(W: torch.Tensor, b: torch.Tensor, apos, avel, ishape, ivel):
    """concat_i(obs_i) · W + b from the state; W [6N·N, H]."""
    n = apos.shape[-2]
    H = W.shape[-1]
    Wb = W.reshape(n, 6 * n, H)  # agent i's block of rows
    Wr = Wb[:, 2: 2 * n].reshape(n, n - 1, 2, H)  # [i, slot, c, h]
    cs = torch.cumsum(Wr, 0)  # Σ_{i' ≤ i}
    j = torch.arange(n - 1, device=W.device)
    diag = cs[j, j]  # Σ_{i ≤ j} Wr[i, j]: agent j + 1 seen from the agents before it
    above = cs[-1] - diag  # Σ_{i > j} Wr[i, j]: agent j seen from the agents after it
    z = torch.zeros_like(diag[:1])
    V = torch.cat([above, z], 0) + torch.cat([z, diag], 0)  # [k, c, h]
    U = Wr.sum(1)  # [i, c, h]
    flat = lambda x, w: x.flatten(-2) @ w.reshape(2 * n, H)
    h = (flat(avel, Wb[:, 0:2]) + flat(apos, V) - flat(apos, U)
         + ishape.flatten(-2) @ Wb[:, 4 * n - 2: 6 * n - 2].sum(0) + ivel @ Wb[:, 6 * n - 2:].sum(0))
    return h + b


def actor_forward(p: Params, parts, factorized: bool):
    """(mean [..., N, 2], bounded log-std [2])."""
    W, b = p["actor.mlp.layers.0.weight"], p["actor.mlp.layers.0.bias"]
    if factorized:
        h1 = _actor_h1_factorized(W.T, b, *parts)
    else:
        h1 = observation(*parts) @ W.T + b
    mean = _dense(p, "actor.head", _trunk_tail(p, "actor", h1))
    return mean, soft_bound(p["actor.log_std"], -5.0, 2.0)


def critic_forward(p: Params, parts, factorized: bool) -> torch.Tensor:
    W, b = p["critic.mlp.layers.0.weight"], p["critic.mlp.layers.0.bias"]
    if factorized:
        h1 = _critic_h1_factorized(W.T, b, *parts)
    else:
        h1 = observation(*parts).flatten(-2) @ W.T + b
    return _dense(p, "critic.head", _trunk_tail(p, "critic", h1))[..., 0]


# -- collection -------------------------------------------------------------------

class HashNoise:
    """The fused collection's draws: action normals and fresh episodes from
    the counter PRNG, keyed by (seed, step, row, env)."""

    def __init__(self, seeds: List[int], B: int, n: int, device):
        self.seeds, self.n = seeds, n
        self.envs = torch.arange(B, device=device)

    def actions(self, it: int, step: int, dtype) -> torch.Tensor:
        z = prng.normal(self.seeds[it], step, self.envs, 2 * self.n, 1, dtype)  # [2n, B]
        return z.reshape(self.n, 2, -1).permute(2, 0, 1)

    def reset(self, it: int, step: int, dtype):
        n = self.n
        u = (prng.uniform01(self.seeds[it], step, self.envs, 4 * n + 2, 3) * 2.0 - 1.0).to(dtype)
        apos = torch.stack([u[:n].T, u[n: 2 * n].T], -1)
        lpos = torch.stack([u[2 * n: 3 * n].T, u[3 * n: 4 * n].T], -1)
        return apos, lpos - lpos.mean(1, keepdim=True), u[4 * n:].T


class GeneratorNoise:
    """The step-by-step collection's draws from a torch.Generator, in the
    order the env consumes it each step: the action normals [B, N, 2], then
    a fresh batch of episodes (the reset draw is made every step)."""

    def __init__(self, generator: torch.Generator, B: int, n: int):
        self.g, self.B, self.n = generator, B, n

    def actions(self, it: int, step: int, dtype) -> torch.Tensor:
        return torch.randn((self.B, self.n, 2), generator=self.g, device=self.g.device,
                           dtype=torch.float32).to(dtype)

    def reset(self, it: int, step: int, dtype):
        return tuple(x.to(dtype) for x in F.draw_reset(self.g, self.B, self.n))


def collect(p: Params, st: F.State, w: F.World, cfg: PPO, noise, it: int, factorized: bool):
    """``rollout_len`` steps of every env.  Returns the state after them and
    the trajectory: parts (apos, avel, ishape, ivel) [T, B, ...], action,
    logp [T, B, N], value, reward, done [T, B], and the last value [B]."""
    dt = st.apos.dtype
    traj = {k: [] for k in ("apos", "avel", "ishape", "ivel", "action", "logp", "value", "reward", "done")}
    with torch.no_grad():
        for step in range(cfg.rollout_len):
            parts = (st.apos, st.avel, st.ishape, st.ivel)
            mean, log_std = actor_forward(p, parts, factorized)
            z = noise.actions(it, step, dt)
            action = mean + torch.exp(log_std) * z
            logp = (-0.5 * (z * z) - log_std - 0.5 * LOG_2PI).sum(-1)
            value = critic_forward(p, parts, factorized)
            force = F.contact_forces(st.apos, w) + w.sensitivity * action
            npos, nvel = F.integrate(st.apos, st.avel, force, w)
            reward = F.env_reward(npos, nvel, st.ishape, st.ivel, w)
            t = st.t + 1
            done = t >= w.episode_length
            apos, ishape, ivel = noise.reset(it, step, dt)
            fresh = F.State(apos, torch.zeros_like(apos), ishape, ivel, torch.zeros_like(t))
            for k, v in zip(traj, (*parts, action, logp, value, reward, done)):
                traj[k].append(v)
            st = F.select(done, fresh, F.State(npos, nvel, st.ishape, st.ivel, t))
        last_value = critic_forward(p, (st.apos, st.avel, st.ishape, st.ivel), factorized)
    return st, {k: torch.stack(v) for k, v in traj.items()}, last_value


# -- GAE, the value normaliser and the update -----------------------------------

@dataclasses.dataclass
class ValueNorm:
    mean: float = 0.0
    mean_sq: float = 1.0
    count: float = 1e-4

    @property
    def std(self) -> float:
        return math.sqrt(max(self.mean_sq - self.mean ** 2, 1e-8))


def targets(traj, last_value, vn: ValueNorm, cfg: PPO):
    """GAE in raw return space; returns (normalised advantages, normalised
    value targets, the updated normaliser)."""
    values = traj["value"] * vn.std + vn.mean
    nxt = last_value * vn.std + vn.mean
    gae = torch.zeros_like(nxt)
    adv = []
    for t in reversed(range(values.shape[0])):
        nonterm = 1.0 - traj["done"][t].to(values.dtype)
        delta = traj["reward"][t] + cfg.gamma * nxt * nonterm - values[t]
        gae = delta + cfg.gamma * cfg.gae_lambda * nonterm * gae
        adv.append(gae)
        nxt = values[t]
    adv = torch.stack(adv[::-1])
    ret = adv + values
    k = ret.numel()
    n = vn.count + k
    wgt = k / n
    vn = ValueNorm(mean=vn.mean * (1 - wgt) + float(ret.mean()) * wgt,
                   mean_sq=vn.mean_sq * (1 - wgt) + float((ret * ret).mean()) * wgt, count=n)
    adv_n = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-5)
    return adv_n, (ret - vn.mean) / vn.std, vn


def huber(x, delta: float):
    a = x.abs()
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def loss_sums(p: Params, b: Dict[str, torch.Tensor], cfg: PPO, factorized: bool):
    """Sums over a block of samples of the policy term (over samples and
    agents) and the value term (over samples)."""
    parts = (b["apos"], b["avel"], b["ishape"], b["ivel"])
    mean, log_std = actor_forward(p, parts, factorized)
    var = torch.exp(2 * log_std)
    logp = (-0.5 * (b["action"] - mean) ** 2 / var - log_std - 0.5 * LOG_2PI).sum(-1)
    ratio = torch.exp(torch.clamp(logp - b["logp"], -20.0, 20.0))
    adv = b["adv"][:, None]
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).sum()
    v = critic_forward(p, parts, factorized)
    v_clip = b["value"] + torch.clamp(v - b["value"], -cfg.clip_eps, cfg.clip_eps)
    vl = torch.maximum(huber(v - b["target"], cfg.huber_delta), huber(v_clip - b["target"], cfg.huber_delta)).sum()
    return pg, vl


class Adam:
    """Global-norm clip (scale by max_norm/‖g‖ when ‖g‖ ≥ max_norm), then
    Adam with bias correction and eps outside the root."""

    def __init__(self, params: Params, cfg: PPO):
        self.cfg = cfg
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, params: Params, grads: Params) -> Params:
        cfg = self.cfg
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm), cfg.max_grad_norm / norm)
        self.count += 1
        c1, c2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        out = {}
        for k, g in grads.items():
            g = g * scale
            self.mu[k] = 0.1 * g + 0.9 * self.mu[k]
            self.nu[k] = 0.001 * g * g + 0.999 * self.nu[k]
            out[k] = params[k] - cfg.lr * (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + cfg.adam_eps)
        return out


def epoch_grad(p: Params, data: Dict[str, torch.Tensor], cfg: PPO, factorized: bool, block_rows: int, n: int):
    """The gradient of one epoch's loss on the whole batch at ``p``, summed
    over blocks of rows, and its (policy loss, value loss, entropy, total
    loss)."""
    M = data["adv"].shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    pg_sum = vl_sum = 0.0
    for s in range(0, M, block_rows):
        blk = {k: v[s: s + block_rows] for k, v in data.items()}
        pg, vl = loss_sums(leaves, blk, cfg, factorized)
        part = pg / (M * n) + cfg.value_coef * vl / M
        gs = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
        for (k, _), g in zip(leaves.items(), gs):
            if g is not None:
                grads[k] += g
        pg_sum, vl_sum = pg_sum + float(pg.detach()), vl_sum + float(vl.detach())
    ls = leaves["actor.log_std"]
    ent_term = (soft_bound(ls, -5.0, 2.0) + 0.5 * math.log(2 * math.pi * math.e)).sum()
    (g_ent,) = torch.autograd.grad(-cfg.entropy_coef * ent_term, [ls])
    grads["actor.log_std"] += g_ent
    pg, vl, ent = pg_sum / (M * n), vl_sum / M, float(ent_term.detach())
    return grads, dict(pg_loss=pg, v_loss=vl, entropy=ent, loss=pg - cfg.entropy_coef * ent + cfg.value_coef * vl)


def update(p: Params, opt: Adam, data: Dict[str, torch.Tensor], cfg: PPO, factorized: bool,
           block_rows: int, n: int, record: Optional[list] = None, record_epochs: int = 0):
    """``ppo_epochs`` steps on the whole batch.  Returns the parameters and
    the epochs' mean of (policy loss, value loss, entropy, total loss);
    ``record`` receives (parameters before, gradient, losses) of the first
    ``record_epochs`` epochs, and the parameters before epoch
    ``record_epochs + 1``."""
    mets = []
    for e in range(cfg.ppo_epochs):
        grads, met = epoch_grad(p, data, cfg, factorized, block_rows, n)
        if record is not None and e < record_epochs:
            record.append((p, grads, met))
        p = opt.step(p, grads)
        if record is not None and e + 1 == record_epochs:
            record.append((p, None, None))
        mets.append(met)
    return p, {k: sum(m[k] for m in mets) / len(mets) for k in mets[0]}


def train(p0: Params, st0: F.State, w: F.World, cfg: PPO, noise, iters: int, factorized: bool,
          dtype=torch.float64, block_rows: int = 1 << 14, capture: Optional[list] = None,
          steps: Optional[list] = None):
    """``iters`` MAPPO iterations from ``p0`` and ``st0`` in ``dtype``.
    Returns (per-iteration losses and mean step rewards, Adam's first moment after iteration 1,
    the parameters after the last).  ``capture`` receives each
    iteration's collection and ``steps`` its optimizer steps, as
    :func:`train_on` takes them."""
    p = {k: v.detach().to(dtype) for k, v in p0.items()}
    st = st0.to(dtype)
    opt = Adam(p, cfg)
    vn = ValueNorm()
    losses, mu1 = [], None
    for it in range(iters):
        st_in = st
        st, traj, last_value = collect(p, st, w, cfg, noise, it, factorized)
        if capture is not None:
            capture.append((st_in, dict(traj), last_value, st))
        adv, tgt, vn = targets(traj, last_value, vn, cfg)
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        data = {k: flat(traj[k]) for k in ("apos", "avel", "ishape", "ivel", "action", "logp", "value")}
        data.update(adv=flat(adv), target=flat(tgt))
        data_reward = traj["reward"]
        del traj
        reward = float(data_reward.mean())
        rec = [] if steps is not None else None
        p, met = update(p, opt, data, cfg, factorized, block_rows, w.n, rec, 3 if it == 0 else 1)
        if steps is not None:
            steps.append(rec)
        losses.append(dict(met, mean_step_reward=reward))
        if it == 0:
            mu1 = {k: v.clone() for k, v in opt.mu.items()}
    return losses, mu1, p


# -- following the program's own trajectories ------------------------------------------

def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference over the larger of the reference's largest
    magnitude and 1."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max() / max(float(b.double().abs().max()), 1.0))


def check_steps(p: Params, prog: Dict[str, torch.Tensor], st_in: F.State, st_out: F.State, w: F.World,
                cfg: PPO, noise, it: int, factorized: bool):
    """Each step of the program's collection, from the program's own state
    at that step: the reference's action (its mean and the same normal),
    log density and value there, and its next state and reward under the
    program's action.  Returns the gaps (``policy``, ``state``, the relative
    gap of the mean ``reward``, ``done`` flags that differ)."""
    dt = torch.float64 if p["actor.log_std"].dtype == torch.float64 else p["actor.log_std"].dtype
    T = prog["action"].shape[0]
    gaps = dict(policy=0.0, state=0.0, done=0.0)
    rew_p = rew_r = 0.0
    with torch.no_grad():
        for t in range(T):
            parts = tuple(prog[k][t].to(dt) for k in ("apos", "avel", "ishape", "ivel"))
            mean, log_std = actor_forward(p, parts, factorized)
            z = noise.actions(it, t, dt)
            action = prog["action"][t].to(dt)
            logp = (-0.5 * (action - mean) ** 2 / torch.exp(2 * log_std) - log_std - 0.5 * LOG_2PI).sum(-1)
            value = critic_forward(p, parts, factorized)
            gaps["policy"] = max(gaps["policy"], _gap(prog["action"][t], mean + torch.exp(log_std) * z),
                                 _gap(prog["logp"][t], logp), _gap(prog["value"][t], value))
            force = F.contact_forces(parts[0], w) + w.sensitivity * action
            npos, nvel = F.integrate(parts[0], parts[1], force, w)
            reward = F.env_reward(npos, nvel, parts[2], parts[3], w)
            rew_p += float(prog["reward"][t].double().sum())
            rew_r += float(reward.double().sum())
            steps_in = st_in.t + t + 1  # the step count, before any wrap in this collection
            done = (steps_in % w.episode_length) == 0
            gaps["done"] = max(gaps["done"], float((done != prog["done"][t]).any()))
            apos, ishape, ivel = noise.reset(it, t, dt)
            fresh = F.State(apos, torch.zeros_like(apos), ishape, ivel, torch.zeros_like(steps_in))
            nxt = F.select(done, fresh, F.State(npos, nvel, parts[2], parts[3], steps_in))
            if t + 1 < T:
                target = tuple(prog[k][t + 1] for k in ("apos", "avel", "ishape", "ivel"))
            else:
                target = (st_out.apos, st_out.avel, st_out.ishape, st_out.ivel)
            ours = (nxt.apos, nxt.avel, nxt.ishape, nxt.ivel)
            gaps["state"] = max(gaps["state"], *(_gap(a, b) for a, b in zip(target, ours)))
    gaps["reward"] = abs(rew_p - rew_r) / max(abs(rew_r), 1e-12)
    return gaps


def train_on(p0: Params, trajs, steps, w: F.World, cfg: PPO, noise, factorized: bool, dtype=torch.float64,
             block_rows: int = 1 << 14, device=None):
    """The reference stage by stage on the program's own state: ``trajs``
    its collections (per iteration the state before and after, the
    trajectory and the last value), ``steps`` its optimizer steps (per
    iteration (parameters before, gradient, losses) of the first epoch, of
    the first three in the first iteration, and the parameters the fourth
    starts from).  Each collection step is taken again from the program's
    state with the program's parameters of that iteration (the first
    iteration's are the benchmark's own ``p0``); GAE and the value
    normaliser from the program's trajectory; the first iteration's first
    three optimizer steps from ``p0``, and each later iteration's first
    gradient from the program's parameters.  Returns dict(first_mets,
    later_mets, grads, theta3, gaps, reward): the losses of each
    iteration's first step and of the first iteration's second and third,
    each iteration's first gradient, the parameters after three steps, the
    collection's gaps and each iteration's reward gap."""
    cast = lambda d: {k: v.to(device, dtype) for k, v in d.items()}
    p0 = cast(p0)
    vn = ValueNorm()
    out = dict(first_mets=[], later_mets=[], grads=[], theta3=None, gaps=dict(policy=0.0, state=0.0, done=0.0),
               reward=[])
    for it, ((st_in, prog, last_value, st_out), rec) in enumerate(zip(trajs, steps)):
        prog = {k: v.to(device) for k, v in prog.items()}
        st_in, st_out = (F.State(*(x.to(device) for x in (s.apos, s.avel, s.ishape, s.ivel, s.t)))
                         for s in (st_in, st_out))
        p = p0 if it == 0 else cast(rec[0][0])
        gaps = check_steps(p, prog, st_in, st_out, w, cfg, noise, it, factorized)
        for k in out["gaps"]:
            out["gaps"][k] = max(out["gaps"][k], gaps[k])
        out["reward"].append(gaps["reward"])
        traj = {k: (v if k == "done" else v.to(dtype)) for k, v in prog.items()}
        adv, tgt, vn = targets(traj, last_value.to(device, dtype), vn, cfg)
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        data = {k: flat(traj[k]) for k in ("apos", "avel", "ishape", "ivel", "action", "logp", "value")}
        data.update(adv=flat(adv), target=flat(tgt))
        del traj, prog
        if it == 0:
            opt = Adam(p, cfg)
            for e in range(3):
                g, met = epoch_grad(p, data, cfg, factorized, block_rows, w.n)
                out["later_mets" if e else "first_mets"].append(met)
                if e == 0:
                    out["grads"].append(g)
                p = opt.step(p, g)
            out["theta3"] = p
        else:
            g, met = epoch_grad(p, data, cfg, factorized, block_rows, w.n)
            out["first_mets"].append(met)
            out["grads"].append(g)
    return out
