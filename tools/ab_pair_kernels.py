"""Time the port's kernels on the card, against a parent checkout or by phase.

    python tools/ab_pair_kernels.py [--set pair|k2k9|k5k7|k4] [--root DIR] [--out PATH]
    python tools/ab_pair_kernels.py [--set pair|k2k9|k5k7|k4] --ab PARENT_DIR [--rounds R] [--out PATH]
    python tools/ab_pair_kernels.py --phases k3|k8|k2k9|k5|k4 [--out PATH]

With ``--root`` (default: this checkout) it imports
``gym_formation_tpu_torch`` from DIR, builds its kernels, and prints one
JSON line for the kernel set (``--set``, default ``pair``):

``pair``, the pair kernels K1, K3, K6 and K8:

- ``k1_ms``: K1 at N=243, B=4096, on the agents of a fresh
  ``formation_hd_env`` batch (the step path's shapes; K1 evaluates every
  pair, so its time does not depend on the positions);
- ``k6_ms``: K6 at the hd_obs colliding subset of N=243 (E=246), B=4096,
  on the positions of a fresh ``formation_hd_obs_env`` batch;
- ``k8_ms``: K8's whole wrapper at N=243, B=4096, on the agents after the
  128 steps of the cull selector path below (the cull path's state), and
  ``k8_near``: the ordered pairs of that state within K8's cutoff;
- ``k3_ms``: K3 at N=243, B=4096, the in-kernel BFS, ``stats="pre"``, on a
  fresh ``formation_hd_env`` batch;
- ``fused``: env-steps/s of the fused path (``rollout_statepolicy_fused``,
  ``policy="bfs_ez"``, ``stats="pre"``, N=243, B=4096; K3 once a step),
  ``hd_obs``: of the hd_obs path (``formation_hd_obs_env``, N=243, B=4096,
  a linear policy; K6 once a step), ``step``: of the step path
  (``rollout_statepolicy_rewardsum`` under the BFS + ezpolicy controller,
  N=243, B=4096; K1 once a step) and ``cull``: of the same path under
  ``set_pallas_impl("cull")`` (K8 once a step).

``k2k9``, the reward statistics K2 and the fused PPO gradient K9:

- ``k2_ms``: K2 at N=243, B=4096 on the step path's state after its 128
  steps; ``k7_ms``: K7, the row-major kernel of the same function, on the
  same inputs;
- ``k9_ms``: K9 at M = 102,400 (MAPPO N=3, B=4096, T=25) on a real
  trajectory after ``_prepare``, as ``chip_smoke.py: phase_k9`` builds it;
- ``collect_ms``, ``prepare_ms``, ``update_ms``: the MAPPO N=3 fused
  iteration by CUDA events, each the median of 3 iterations after four
  ``train_step`` calls, and ``mappo_n3``: training env-steps/s, the median
  of 3 ``train_step`` walls;
- ``step``, ``fused``: env-steps/s of the step path and of the fused path,
  as above; ``mappo_n243``: training env-steps/s of MAPPO's structured path
  at N=243, B=1024 (median of 2 iterations after a warm-up).

``k5k7``, the fused MAPPO collection K5 and the row-major reward
statistics K7:

- ``k5_ms``: K5 at n=3, B=4096, T=25 (the MAPPO N=3 training shape) on a
  fresh batch with the episode counters spread over ep_len 10, as
  ``chip_smoke.py: phase_k5`` builds it; ``k5n9_ms``: the same at n=9;
- ``k7_ms``, ``k2_ms``: K7 and K2 at N=243, B=4096 on the step path's
  state after its 128 steps (``step``: that path's env-steps/s);
- ``collect_ms``, ``prepare_ms``, ``update_ms`` and ``mappo_n3``: the MAPPO
  N=3 fused iteration, as for ``k2k9``.

``k4``, the whole-rollout kernel K4:

- ``k4_ms``: K4 at n=3, B=4096, 256 steps, ep_len 100, on the state of
  ``chip_smoke.py``'s N=3 path (the second ``reset_state`` of a
  ``formation_hd_env`` batch from seed 3); ``k4n9_ms``: the same at n=9;
- ``n3``: env-steps/s of the N=3 path (one K4 call of 256 steps a window).

Each kernel time is the mean of 20 calls by CUDA events after a warm-up, as
``chip_smoke.py: time_ms`` takes it, with the host's time a call to enqueue
them beside (``<kernel>_enqueue_ms``): where the two meet, the host paces
the calls.  Each rate is the median of 3 windows of steps, each closed by a
host fetch, after one warm-up window, with the host's enqueue ms a step
beside.  ``ptxas``: the compiler's register and spill lines of the set's
kernels; ``sass``: each loop (a backward branch) of their compiled code
that holds an exp (``MUFU.EX2``, one a pair evaluation) or at least 16 FP32
instructions, with its instruction count and the count of each kind (from
``cuobjdump -sass`` of the built library; ``null`` without ``cuobjdump``).

With ``--ab PARENT_DIR`` it runs itself on PARENT_DIR and on this checkout
in turns (parent, change, change, parent; ``--rounds`` times), one process
each, and prints each line and each side's means and spreads.

With ``--phases`` it times a kernel by phase: it copies
``gym_formation_tpu_torch`` into ``build/phases/<name>/<variant>/``, cuts
a phase out of the copy's sources (``PHASES``), and times each copy (one
process a copy, the full kernels first and last).  A phase's time is the
full kernel's minus the copy's: the phases overlap on the card, so the
shares are estimates.  The copies compute wrong results and serve only this
timing.

- ``k3``: K3 at N=243, B=4096, ``stats="pre"``, with the in-kernel BFS and
  with external actions; without the Hausdorff statistics, without the pair
  sweep, without both.
- ``k8``: K8 on the cull path's state; without the pair loop, then also
  with the one warp's placement by cell replaced by a placement in index
  order.
- ``k2k9``: K2 without its collision counts or its Hausdorff tiles, or
  built for three blocks an SM; K9 without dW1, without its last two phases
  (dW2, g1 and dW1), with one role's launch only, without its sums over
  blocks.
- ``k5``: K5 at n=3 and n=9 (``k5k7``'s inputs) with the layer products
  and heads alone (the scalar phase of the env threads cut out), with the
  scalar phase alone (the two layers and the heads cut out), and without
  the heads.
- ``k4``: K4 at n=3 and n=9 (``k4``'s inputs) without the policy (a zero
  force in its place), without the pair phase, without the reward phase.

Needs a CUDA device and ``nvcc``; exits 1 without a device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = "gym_formation_tpu_torch"
B, N = 4096, 243


def time_ms(fn, reps=20):
    """(device ms, host enqueue ms) a call: CUDA events over ``reps`` calls
    after a warm-up (``chip_smoke.py: time_ms``), and the host's clock over
    the same calls before the device is waited for."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, enqueue


def timed(out, name, fn):
    out[name + "_ms"], out[name + "_enqueue_ms"] = time_ms(fn)


def rate(window, steps, envs=B):
    """(env-steps/s, host enqueue ms a step): medians of 3 windows of
    ``steps`` steps, each closed by a host fetch of ``window()``'s result."""
    import torch

    window().cpu()  # warm-up
    rates, enq = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = window()
        enq.append((time.perf_counter() - t0) * 1e3 / steps)
        r.cpu()
        rates.append(envs * steps / (time.perf_counter() - t0))
    return statistics.median(rates), statistics.median(enq)


def _cuda_tool(name):
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    return str(cand) if cand.exists() else None


def sass_loops(library: Path, symbols):
    """{kernel symbol: [loop, ...]} for the loops of the named kernels that
    hold an exp or at least 16 FP32 instructions."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not any(k in name for k in symbols):
            continue
        # "/*0a30*/   @!P0 BRA 0x950 ;" -> (address, opcode, operands)
        ins = [(int(m.group(1), 16), m.group(3), m.group(4))
               for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", block)]
        loops = []
        for addr, op, args in ins:
            t = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
            if t is None or int(t.group(1), 16) >= addr:
                continue
            start = int(t.group(1), 16)
            body = [o for a, o, _ in ins if start <= a <= addr]
            kinds = Counter(o if o.startswith(("LDS", "MUFU")) else o.split(".")[0] for o in body)
            fp32 = sum(kinds.get(k, 0) for k in ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP"))
            if kinds.get("MUFU.EX2", 0) or fp32 >= 16:
                loops.append(dict(start=hex(start), end=hex(addr), instructions=len(body),
                                  exps=kinds.get("MUFU.EX2", 0), kinds=dict(kinds.most_common(12))))
        out.setdefault(name, []).extend(loops)
    return out


def ptxas_lines(library: Path, symbols):
    log = library.parent / "ptxas.log"
    if not log.exists():
        return None
    lines, keep = [], False
    for line in log.read_text().splitlines():
        if "Compiling entry" in line:
            keep = any(k in line for k in symbols)
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def _package(root: Path):
    """``gym_formation_tpu_torch`` imported from ``root``."""
    import torch

    if not torch.cuda.is_available():
        print("ab_pair_kernels: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(root))
    import gym_formation_tpu_torch as gt

    assert Path(gt.__file__).resolve().is_relative_to(root.resolve()), gt.__file__
    return gt


def _step_path(gt, hd):
    """The step path's window (32 steps under the BFS + ezpolicy
    controller) and a box holding its state."""
    policy = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, hd.env.scenario, s, 3)
    box = [hd.reset_state()]

    def step(steps=32):
        box[0], r = gt.rollout_statepolicy_rewardsum(hd.env, policy, box[0], hd.generator, steps)
        return r

    return step, box


def _fused_path(gt, hd):
    box = [hd.reset_state()]

    def fused(steps=32):
        box[0], r = gt.rollout_statepolicy_fused(hd.env, None, box[0], hd.generator, steps, stats="pre",
                                                 policy="bfs_ez")
        return r.sum(0)

    return fused


def cull_state(gt, hd):
    """The step path under ``set_pallas_impl("cull")`` from a fresh state,
    as ``rate`` measures it (4 windows of 32 steps): (env-steps/s, enqueue
    ms a step, the state after the 128 steps: the cull path's state)."""
    from gym_formation_tpu_torch.core import set_pallas_impl

    step, box = _step_path(gt, hd)
    set_pallas_impl("cull")
    try:
        steps_per_s, enqueue_ms = rate(step, 32)
    finally:
        set_pallas_impl("auto")
    return steps_per_s, enqueue_ms, box[0]


# -- kernel sets ---------------------------------------------------------------

def measure_pair(root: Path) -> dict:
    import numpy as np
    import torch

    gt = _package(root)
    from gym_formation_tpu_torch.core import make_world_cfg
    from gym_formation_tpu_torch.core.physics import _collide_subset
    from gym_formation_tpu_torch.ops.kernels import fused_step as k3
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8
    from gym_formation_tpu_torch.ops.kernels import pairforce_sym as k1

    dev = torch.device("cuda")
    out = dict(root=str(root), device=torch.cuda.get_device_name(0))
    obs = gt.make_vec_env("formation_hd_obs_env", num_envs=B, num_agents=N, device=dev, seed=0)
    _, _, idx, sub = _collide_subset(obs.env.scenario.cfg)
    pos6 = obs.reset_state().pos[:, torch.as_tensor(idx, device=dev)].contiguous()
    hd = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=N, device=dev, seed=0)
    st = hd.reset_state()
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    kw = dict(thresh=0.03, stats="pre", bfs_L=5, ideal_vel=st.ideal_vel, act_scale=5.0)
    out["E6"] = pos6.shape[1]
    timed(out, "k6", lambda: k6.collision_forces_batched(pos6, sub))
    timed(out, "k3", lambda: k3.fused_hd_step(st.pos[:, :N], st.vel[:, :N], None, st.ideal_shape, cfg, **kw))
    pos1 = st.pos[:, :N].contiguous()
    timed(out, "k1", lambda: k1.collision_forces_sym(pos1, cfg))
    out["cull"], out["cull_enqueue_ms"], cstate = cull_state(gt, hd)
    pos8 = hd.env.scenario.agent_pos(cstate).contiguous()
    timed(out, "k8", lambda: k8.collision_forces_culled(pos8, cfg))
    d = pos8[:, :, None, :] - pos8[:, None, :, :]
    out["k8_near"] = int(((d * d).sum(-1) < k8.cutoff(cfg) ** 2).sum()) - B * N
    out["step"], out["step_enqueue_ms"] = rate(_step_path(gt, hd)[0], 32)
    out["fused"], out["fused_enqueue_ms"] = rate(_fused_path(gt, hd), 32)
    W = torch.as_tensor(np.random.RandomState(7).normal(size=(obs.env.scenario.obs_dim, 2)),
                        dtype=torch.float32, device=dev) / np.sqrt(obs.env.scenario.obs_dim)
    ostate, o = obs.reset()

    def hd_obs(steps=8):
        nonlocal ostate, o
        rs = torch.zeros(B, device=dev)
        for _ in range(steps):
            ostate, step_out = obs.step(ostate, torch.clamp(o @ W, -1.0, 1.0))
            o = step_out.obs
            rs = rs + step_out.reward.sum(-1)
        return rs

    out["hd_obs"], out["hd_obs_enqueue_ms"] = rate(hd_obs, 8)
    return out


def k9_operands(algo, dev):
    """K9's operands and batch from a real MAPPO N=3 trajectory after
    ``_prepare`` (as ``chip_smoke.py: phase_k9``)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    ts, es, obs = algo.init(g)
    with torch.no_grad():
        es, obs, traj, _, last_value = algo._collect_fused(ts, es, obs, g)
    ts, data = algo._prepare(ts, traj, last_value)
    f = lambda t: t.detach().float().contiguous()
    (a1, a2), (c1, c2) = ts.actor.mlp.layers, ts.critic.mlp.layers
    aops = (f(a1.weight.T), f(a1.bias), f(a2.weight.T), f(a2.bias), f(ts.actor.head.weight.T),
            f(ts.actor.head.bias), f(ts.actor.bounded_log_std()))
    cops = (f(c1.weight.T), f(c1.bias), f(c2.weight.T), f(c2.bias), f(ts.critic.head.weight.T),
            f(ts.critic.head.bias))
    sub = {k: data[k] for k in ("obs", "action", "logp", "adv", "value", "target")}
    kw = dict(n_agents=3, act_dim=2, clip_eps=algo.cfg.clip_eps, huber_delta=algo.cfg.huber_delta,
              value_coef=algo.cfg.value_coef)
    return sub, aops, cops, kw


def split_iteration(algo, ts, es, obs, g):
    """One iteration as ``train_step`` runs it, with CUDA events between
    collect, prepare and update (ms of each) and the state after it."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    with torch.no_grad():
        es, obs, traj, _, last_value = algo._collect_fused(ts, es, obs, g)
    ev[1].record()
    ts, data = algo._prepare(ts, traj, last_value)
    ev[2].record()
    ts, m = algo._update_fused(ts, data, g)
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], ts, es, obs


def train_walls(algo, ts, es, obs, g, iters):
    import torch

    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, es, obs, m = algo.train_step(ts, es, obs, g)
        [float(v) for v in m.values()]  # the host fetch that closes an iteration
        walls.append(time.perf_counter() - t0)
    return walls, ts, es, obs


def mappo_split(algo, dev, out):
    """``mappo_n3``: training env-steps/s of ``algo`` (the median of 3
    ``train_step`` walls after a warm-up), and ``collect_ms``, ``prepare_ms``,
    ``update_ms``: the medians of 3 split iterations, into ``out``.  Returns
    the generator."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ts, es, obs = algo.init(g)
    walls, ts, es, obs = train_walls(algo, ts, es, obs, g, 4)
    out["mappo_n3"] = algo.cfg.rollout_len * B / statistics.median(walls[1:])
    splits = []
    for _ in range(3):
        ms, ts, es, obs = split_iteration(algo, ts, es, obs, g)
        splits.append(ms)
    for i, k in enumerate(("collect", "prepare", "update")):
        out[k + "_ms"] = statistics.median(s[i] for s in splits)
    return g


def measure_k2k9(root: Path, full: bool = True) -> dict:
    import torch

    gt = _package(root)
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9
    from gym_formation_tpu_torch.ops.kernels import reward as k7
    from gym_formation_tpu_torch.ops.kernels import reward_sym as k2

    dev = torch.device("cuda")
    out = dict(root=str(root), device=torch.cuda.get_device_name(0))
    hd = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=N, device=dev, seed=0)
    step, box = _step_path(gt, hd)
    out["step"], out["step_enqueue_ms"] = rate(step, 32)  # 128 steps: the step path's state
    pos, ishape = hd.env.scenario.agent_pos(box[0]).contiguous(), box[0].ideal_shape.contiguous()
    timed(out, "k2", lambda: k2.hd_reward_stats_sym(pos, ishape, thresh=0.03))
    timed(out, "k7", lambda: k7.hd_reward_stats_batched(pos, ishape, thresh=0.03))
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3), MAPPOConfig(fused_update=True),
                 num_envs=B, device=dev)
    sub, aops, cops, kw = k9_operands(algo, dev)
    out["k9_M"] = int(sub["obs"].shape[0])
    timed(out, "k9", lambda: k9.fused_ppo_grads(sub, aops, cops, **kw))
    if not full:
        return out

    g = mappo_split(algo, dev, out)
    out["fused"], out["fused_enqueue_ms"] = rate(_fused_path(gt, hd), 32)
    big = MAPPO(gt.make_env("formation_hd_env", num_agents=N), MAPPOConfig(), num_envs=1024, device=dev)
    ts2, es2, obs2 = big.init(g)
    walls2, *_ = train_walls(big, ts2, es2, obs2, g, 3)
    out["mappo_n243"] = big.cfg.rollout_len * 1024 / statistics.median(walls2[1:])
    return out


def k5_inputs(gt, n, dev):
    """K5's operands at n agents, B=4096, as ``chip_smoke.py: phase_k5``
    builds them: a fresh ``formation_hd_env`` batch with the episode
    counters spread over ep_len 10, and a GaussianActor and ValueCritic from
    seed 7 with head gains raised."""
    import numpy as np
    import torch
    from gym_formation_tpu_torch.models.networks import GaussianActor, ValueCritic
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
    from gym_formation_tpu_torch.ops.kernels import fused_rollout as k4

    v = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, device=dev, seed=5)
    soa = k4.state_to_soa(v.reset_state())
    t = np.random.RandomState(0).randint(0, 10, (1, B))
    soa = soa._replace(t=torch.as_tensor(t, dtype=torch.int32, device=dev))
    g = torch.Generator()
    g.manual_seed(7)
    actor = GaussianActor(6 * n, 2, (64, 64), generator=g)
    critic = ValueCritic(6 * n * n, (64, 64), generator=g)
    with torch.no_grad():
        actor.head.weight.mul_(50.0)
        actor.log_std.fill_(-0.5)
    actor, critic = actor.to(dev), critic.to(dev)
    return soa, k5.actor_planes(actor), k5.critic_planes(critic)


def measure_k5k7(root: Path, full: bool = True) -> dict:
    import torch

    gt = _package(root)
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
    from gym_formation_tpu_torch.ops.kernels import reward as k7
    from gym_formation_tpu_torch.ops.kernels import reward_sym as k2

    dev = torch.device("cuda")
    out = dict(root=str(root), device=torch.cuda.get_device_name(0))
    for n, key in ((3, "k5"), (9, "k5n9")):
        soa, aops, cops = k5_inputs(gt, n, dev)
        timed(out, key, lambda: k5.fused_collect_hd(soa, aops, cops, 9, length=25, ep_len=10, n=n))
    if not full:
        return out
    hd = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=N, device=dev, seed=0)
    step, box = _step_path(gt, hd)
    out["step"], out["step_enqueue_ms"] = rate(step, 32)  # 128 steps: the step path's state
    pos, ishape = hd.env.scenario.agent_pos(box[0]).contiguous(), box[0].ideal_shape.contiguous()
    timed(out, "k2", lambda: k2.hd_reward_stats_sym(pos, ishape, thresh=0.03))
    timed(out, "k7", lambda: k7.hd_reward_stats_batched(pos, ishape, thresh=0.03))
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3), MAPPOConfig(fused_update=True),
                 num_envs=B, device=dev)
    mappo_split(algo, dev, out)
    return out


def k4_state(gt, n, dev):
    """The N=3 path's state of ``chip_smoke.py`` at n agents: the second
    ``reset_state`` of a ``formation_hd_env`` batch of B envs from seed 3."""
    from gym_formation_tpu_torch.ops.kernels import fused_rollout as k4

    v = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, device=dev, seed=3)
    v.reset_state()
    return k4.state_to_soa(v.reset_state())


def measure_k4(root: Path, full: bool = True) -> dict:
    import torch

    gt = _package(root)
    from gym_formation_tpu_torch.ops.kernels import fused_rollout as k4

    dev = torch.device("cuda")
    out = dict(root=str(root), device=torch.cuda.get_device_name(0))
    for n, key in ((3, "k4"), (9, "k4n9")):
        soa = k4_state(gt, n, dev)
        timed(out, key, lambda: k4.fused_rollout_hd(soa, 1, length=256, ep_len=100, n=n))
    if not full:
        return out
    box = [k4_state(gt, 3, dev), 0]

    def window():
        box[1] += 1
        box[0], r = k4.fused_rollout_hd(box[0], box[1], length=256, ep_len=100, n=3)
        return r

    out["n3"], out["n3_enqueue_ms"] = rate(window, 256)
    return out


# measure: root -> the line; symbols: the kernels whose ptxas lines and SASS
# loops the line carries; keys: what the A/B summary reads
SETS = {
    "pair": dict(measure=measure_pair,
                 symbols=("pairforce_sym_kernel", "fused_step_kernel", "pairforce_kernel", "pairforce_cull_kernel"),
                 keys=("k1_ms", "k3_ms", "k6_ms", "k8_ms", "step", "step_enqueue_ms", "cull", "cull_enqueue_ms",
                       "fused", "fused_enqueue_ms", "hd_obs", "hd_obs_enqueue_ms")),
    "k2k9": dict(measure=measure_k2k9, symbols=("reward_sym_kernel", "ppo_grad_kernel"),
                 keys=("k2_ms", "k2_enqueue_ms", "k9_ms", "k9_enqueue_ms", "k7_ms", "collect_ms", "prepare_ms",
                       "update_ms", "mappo_n3", "step", "step_enqueue_ms", "fused", "fused_enqueue_ms",
                       "mappo_n243")),
    "k5k7": dict(measure=measure_k5k7, symbols=("fused_collect_kernel", "reward_rowmajor_kernel"),
                 keys=("k5_ms", "k5_enqueue_ms", "k5n9_ms", "k7_ms", "k7_enqueue_ms", "k2_ms", "collect_ms",
                       "prepare_ms", "update_ms", "mappo_n3", "step", "step_enqueue_ms")),
    "k4": dict(measure=measure_k4, symbols=("fused_rollout_kernel",),
               keys=("k4_ms", "k4_enqueue_ms", "k4n9_ms", "k4n9_enqueue_ms", "n3", "n3_enqueue_ms")),
}


def measure(kind: str, root: Path) -> dict:
    spec = SETS[kind]
    out = spec["measure"](root)
    from gym_formation_tpu_torch.ops import _build  # from root: the set's measure put it on the path

    lib = _build.build()
    out["ptxas"] = ptxas_lines(lib, spec["symbols"])
    out["sass"] = sass_loops(lib, spec["symbols"])
    return out


# -- phases: copies with a phase cut out ----------------------------------------

def measure_k3(root: Path) -> dict:
    import torch

    gt = _package(root)
    from gym_formation_tpu_torch.core import make_world_cfg
    from gym_formation_tpu_torch.ops.kernels import fused_step as k3

    dev = torch.device("cuda")
    st = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=N, device=dev, seed=0).reset_state()
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    act = torch.zeros(B, N, 2, device=dev)
    pos, vel = st.pos[:, :N], st.vel[:, :N]
    out = {}
    timed(out, "bfs_ez", lambda: k3.fused_hd_step(pos, vel, None, st.ideal_shape, cfg, thresh=0.03,
                                                   stats="pre", bfs_L=5, ideal_vel=st.ideal_vel, act_scale=5.0))
    timed(out, "external", lambda: k3.fused_hd_step(pos, vel, act, st.ideal_shape, cfg, thresh=0.03,
                                                     stats="pre"))
    return out


def measure_k8(root: Path) -> dict:
    import torch

    gt = _package(root)
    from gym_formation_tpu_torch.core import make_world_cfg
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    hd = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=N, device=torch.device("cuda"), seed=0)
    *_, st = cull_state(gt, hd)
    pos = hd.env.scenario.agent_pos(st).contiguous()
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    out = {}
    timed(out, "k8", lambda: k8.collision_forces_culled(pos, cfg))
    return out


# A cut (file in csrc/, start, end, new) replaces the text from ``start``
# through the end of ``end`` with ``new``.
K3_STATS = ("fused_step.cu", "  const float h = haus_rect(post ? qx : x,", ";", "  const float h = 0.f;")
K3_PAIRS = ("fused_step.cu", "  if (post)\n    pair_sweep(UniformPair<true, false>", "N, own, react);\n\n", "")
K8_PAIRS = ("pairforce_cull.cu", "#pragma unroll 2\n        for (int j = j0; j < j1; ++j) {",
            "          fy += w * (g * dy);\n        }\n", "")
K8_PLACE = ("pairforce_cull.cu", "  if (warp == 0) {\n    for (int base = (E - 1) & ~31;",
            "      __syncwarp();\n    }\n  }\n", "  for (int e = tid; e < E; e += nt) orig[e] = e;\n")
K2_HAUS = ("common.cuh", "  for (int P = 0; P < T; ++P) {\n    const int i0 = P * S + a;\n    float ax[R]",
           "atomicMin(rmin + i0 + 16 * k, __float_as_int(r));\n    }\n  }\n", "")
K2_COUNTS = ("common.cuh", "  for (int P = 0; P < T; ++P) {\n    const int i0 = P * S + a;\n    float ix[R]",
             "atomicAdd(cnt + i0 + 16 * k, s);\n      }\n    }\n  }\n", "")
K2_3_BLOCKS = ("reward_sym.cu", "__launch_bounds__(HD_THREADS, 4)", ")", "__launch_bounds__(HD_THREADS, 3)")
K9_PHASE4_END = "*p = first ? aW1[q][j] : *p + aW1[q][j];\n            }\n        }\n      }\n    }\n"
K9_DW1 = ("fused_ppo_grad.cu", "    // ---- 4. dW1", K9_PHASE4_END, "")
K9_FORWARD = ("fused_ppo_grad.cu", "    // ---- 3. dW2", K9_PHASE4_END, "")
K9_ACTOR = ("fused_ppo_grad.cu", "  return (int)launch_role<false>(gc, s);", ";", "  return 0;")
K9_CRITIC = ("fused_ppo_grad.cu", "  cudaError_t err = launch_role<true>(ga, s);", ";",
             "  cudaError_t err = cudaSuccess;")
K9_NO_SUM = ("fused_ppo_grad.cu", "  slice_sum_kernel<<<", ";", "")
K5_SCALAR_START = "      // ---- scalar phase: one thread an env\n"
K5_SCALAR = ("fused_collect.cu", K5_SCALAR_START, "      // ---- end of the scalar phase\n", "")
K5_PRODUCTS = ("fused_collect.cu", "      // ---- layer 1\n", "      __syncthreads();\n" + K5_SCALAR_START,
               "      __syncthreads();\n" + K5_SCALAR_START)
K5_HEADS = ("fused_collect.cu", "      // ---- heads", "      __syncthreads();\n" + K5_SCALAR_START, K5_SCALAR_START)
K4_POLICY = ("fused_rollout.cu", "  // ---- ezpolicy", "  // ---- end of the policy\n", "  float fx = 0.f, fy = 0.f;\n")
K4_PAIRS = ("fused_rollout.cu", "  // ---- pairs", "  // ---- end of the pairs\n", "")
K4_COEFS = ("fused_rollout.cu", "  // ---- pair coefficients", "  // ---- end of the pair coefficients\n",
            "  float kc[D] = {};\n")
K4_REWARD = ("fused_rollout.cu", "  // ---- reward of the stepped state", "  // ---- end of the reward\n",
             "  o.rew = 0.f;\n")

# measure: root -> the copy's line; order: the variants in turn (the full
# kernel first and last), each a tuple of cuts
PHASES = {
    "k3": dict(measure=measure_k3, order=dict(full=(), no_stats=(K3_STATS,), no_pairs=(K3_PAIRS,),
                                              neither=(K3_STATS, K3_PAIRS))),
    "k8": dict(measure=measure_k8, order=dict(full=(), no_pairs=(K8_PAIRS,), no_place=(K8_PAIRS, K8_PLACE))),
    "k2k9": dict(measure=lambda root: measure_k2k9(root, full=False),
                 order=dict(full=(), no_counts=(K2_COUNTS,), no_haus=(K2_HAUS,), k2_3_blocks=(K2_3_BLOCKS,),
                            no_dw1=(K9_DW1,), forward=(K9_FORWARD,), actor_only=(K9_ACTOR,),
                            critic_only=(K9_CRITIC,), no_slice_sum=(K9_NO_SUM,))),
    "k5": dict(measure=lambda root: measure_k5k7(root, full=False),
               order=dict(full=(), products_alone=(K5_SCALAR,), scalar_alone=(K5_PRODUCTS,),
                          no_heads=(K5_HEADS,))),
    "k4": dict(measure=lambda root: measure_k4(root, full=False),
               order=dict(full=(), no_policy=(K4_POLICY,), no_pairs=(K4_COEFS, K4_PAIRS), no_reward=(K4_REWARD,))),
}


def cut(src: str, start: str, end: str, new: str) -> str:
    """``src`` with the text from ``start`` through the end of ``end``
    replaced by ``new``."""
    i = src.index(start)
    return src[:i] + new + src[src.index(end, i) + len(end):]


def phases(name: str, out) -> int:
    spec = PHASES[name]
    base = REPO / "build" / "phases" / name
    rows = []
    for variant in list(spec["order"]) + ["full"]:
        root = base / variant
        if not rows or variant != "full":  # a fresh copy of the current source
            shutil.rmtree(root, ignore_errors=True)
            shutil.copytree(REPO / PKG, root / PKG, ignore=shutil.ignore_patterns("__pycache__"))
            for fname, start, end, new in spec["order"][variant]:
                f = root / PKG / "csrc" / fname
                f.write_text(cut(f.read_text(), start, end, new))
        proc = subprocess.run([sys.executable, __file__, "--phases", name, "--root", str(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rows.append(dict(variant=variant, **json.loads(proc.stdout.strip().splitlines()[-1])))
        print(json.dumps(rows[-1]), flush=True)
    full = {k: (rows[0][k] + rows[-1][k]) / 2 for k in rows[0] if k.endswith("_ms") and "enqueue" not in k}
    for r in rows[1:-1]:
        print(f"{name} without {r['variant']}: " + ", ".join(
            f"{k} {r[k]:.4f} (full {full[k]:.4f}, the cut part {full[k] - r[k]:.4f}; host enqueue "
            f"{r[k.replace('_ms', '_enqueue_ms')]:.4f} a call)" for k in full))
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return 0


def ab(kind: str, parent: Path, rounds: int) -> list:
    rows = []
    for root in (parent, REPO, REPO, parent) * rounds:
        proc = subprocess.run([sys.executable, __file__, "--set", kind, "--root", str(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(proc.returncode)
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in rows[-1].items() if k not in ("sass", "ptxas")}), flush=True)
    for key in SETS[kind]["keys"]:
        line = []
        for label, side in (("parent", {0, 3}), ("change", {1, 2})):
            v = [r[key] for i, r in enumerate(rows) if i % 4 in side]
            line.append(f"{label} {statistics.mean(v):.4f} (spread {max(v) - min(v):.4f})")
        print(f"{key}: " + ", ".join(line))
    for label, row in (("parent", rows[0]), ("change", rows[1])):
        for line in row["ptxas"] or []:
            print(f"{label} ptxas: {line}")
        for kernel, loops in (row["sass"] or {}).items():
            for lp in loops:
                per = f", {lp['instructions'] / lp['exps']:.1f} a pair evaluation" if lp["exps"] else ""
                print(f"{label} {kernel} loop {lp['start']}-{lp['end']}: {lp['instructions']} instructions"
                      f"{per}; {lp['kinds']}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--set", choices=sorted(SETS), default="pair")
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--ab", type=Path, default=None, metavar="PARENT_DIR")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--phases", choices=sorted(PHASES), default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.phases is not None:
        if args.root != REPO:  # one copy, in a child
            print(json.dumps(PHASES[args.phases]["measure"](args.root)))
            return 0
        return phases(args.phases, args.out)
    if args.ab is None:
        rows = [measure(args.set, args.root)]
        print(json.dumps(rows[0]))
    else:
        rows = ab(args.set, args.ab, args.rounds)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
