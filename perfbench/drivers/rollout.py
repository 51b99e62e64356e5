"""Rollout traffic of the fused BFS step: ``rollout_statepolicy_fused``
in chunks, each chunk's reward sum fetched to the host before the next
chunk is sent (a closed loop with one caller).

The workload gives ``num_envs``, ``chunk`` (steps a call), ``policy``,
``initial_step``, and the check's ``horizon`` (the steps after a shared
state whose rewards are compared one by one) and ``sample`` (the chunks
checked, drawn from the seed).  Set-up runs one chunk, which builds and
warms every kernel the window runs.
"""

from __future__ import annotations

import time

import torch

from perfbench import counts, harness, judge
from perfbench.drivers import common
from perfbench.reference import formation as F


def _rollout(env, st, gen, wl):
    from gym_formation_tpu_torch.env import rollout_statepolicy_fused

    return rollout_statepolicy_fused(env, None, st, gen, wl["chunk"], stats="pre", policy=wl["policy"])


def _as_ref(es, n) -> F.State:
    return F.State(es.pos[:, :n].clone(), es.vel[:, :n].clone(), es.ideal_shape.clone(),
                   es.ideal_vel.clone(), es.t.to(torch.int64))


def run(c: dict, seed: int, seconds: float, trace: bool, device: str, t0: float, fault=None,
        control: bool = False) -> dict:
    """One run of a rollout cell.  ``fault`` (the tests' and the
    calibration's) wraps the rollout call; ``control`` adds the
    lower-precision control's numbers under ``control``."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.ops.kernels import fused_step, reward_sym

    cfg, wl = c["config"], c["workload"]
    dev = torch.device(device)
    n, B, T = cfg["num_agents"], wl["num_envs"], wl["chunk"]
    _, s_env, s_step, s_pick = harness.seeds(seed)
    marks = [("start", t0), ("imports", time.perf_counter())]
    env = gt.make_env(cfg["scenario"], num_agents=n, episode_length=cfg["episode_length"])
    es, _ = common.first_episodes(n, B, wl["initial_step"], torch.Generator(device=dev).manual_seed(s_env))
    gen = torch.Generator(device=dev).manual_seed(s_step)
    picker = torch.Generator().manual_seed(s_pick)
    roll = _rollout if fault is None else fault(_rollout)
    kept = {}  # chunk index → (start state, rewards, end state)
    sample = set(int(i) for i in torch.randperm(wl["sample_range"], generator=picker)[: wl["sample"]])
    if trace:
        harness.Profiled.warm()

    # chunk 0 builds and warms the kernels; it is checked like any other
    start = _as_ref(es, n)
    es, rew = roll(env, es, gen, wl)
    float(rew.sum())
    kept[0] = (start, rew, _as_ref(es, n))
    common.sync(dev)
    marks.append(("episodes and one chunk", time.perf_counter()))
    common.report_setup(marks)

    kmods = dict(fused_step=fused_step, reward_sym=reward_sym)
    prof, launches0 = None, None
    profile_after = max(0.0, seconds - float(wl.get("profile_seconds", 3.0)))
    t_start = time.perf_counter()
    setup_s = t_start - t0
    chunks = failed = 0
    enqueue_s = 0.0
    while True:
        idx = chunks + 1
        start = _as_ref(es, n) if idx in sample else None
        h0 = time.perf_counter()
        es, rew = roll(env, es, gen, wl)
        enqueue_s += time.perf_counter() - h0
        total = float(rew.sum())  # the host waits for the chunk
        failed += int(not torch.isfinite(torch.tensor(total)))
        if start is not None:
            kept[idx] = (start, rew, _as_ref(es, n))
        chunks += 1
        now = time.perf_counter() - t_start
        if trace and prof is None and now >= profile_after and dev.type == "cuda":
            prof = harness.Profiled()
            prof.start()
            launches0 = {k: mod.launches for k, mod in kmods.items()}
        if now >= seconds:
            break
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tr, launches = None, None
    if prof is not None:
        launches = {k: mod.launches - launches0[k] for k, mod in kmods.items()}
        tr = prof.stop(harness.ROOT / "build" / "perfbench" / f"{c['name']}.{seed}.trace.json")

    steps = chunks * T
    e2e = dict(setup_s=setup_s, env_steps_per_s=harness.rate(steps * B, window_s))
    ctx = dict(harness.trace_context(tr), kind="rollout", n=n, B=B, window_s=window_s, steps=steps,
               launches=launches, host_enqueue_ms=1e3 * enqueue_s / steps,
               mfu=100.0 * counts.rollout_step_ops(n, B) * steps / (window_s * counts.FP32_OPS_PER_S),
               peak_bytes=peak)

    del es, rew
    t_ref = time.perf_counter()
    numbers, ref = check(c, kept, s_step, dev)
    numbers["reference_s"] = time.perf_counter() - t_ref
    correct, checks = harness.checks_block(numbers, c["limits"]["limits"])
    out = dict(e2e=e2e, ctx=ctx, correct=correct and failed == 0, attempted=chunks, failed=failed,
               checks=checks, device=common.device_info(dev, peak), numbers=numbers)
    if control:
        # the reference in bfloat16 in the program's place: the rollout has
        # no matrix product, so TF32 would change nothing
        starts = {k: v[0] for k, v in kept.items()}
        ctl, ctl_whole = reference_rewards(c, starts, s_step, dev, torch.bfloat16)
        ends = {k: v[2][1] for k, v in ctl.items() if v[2] is not None}
        full = lambda k: _scatter(ends[k], ctl[k][2][0], kept[k][2]) if k in ends else kept[k][2]
        out["control"] = compare({k: v[0] for k, v in ctl.items()}, ref[0], ctl_whole, ref[1],
                                 c["limits"]["reward_rel"], {k: full(k) for k in ctl})
    return out


def _scatter(part: F.State, rows, like: F.State) -> F.State:
    """``like`` with ``rows`` replaced by ``part``'s (the control's end states
    in the program's place)."""
    out = F.State(like.apos.clone().double(), like.avel.clone().double(), like.ishape, like.ivel, like.t)
    out.apos[rows] = part.apos.double()
    out.avel[rows] = part.avel.double()
    return out


def level_count(n: int) -> int:
    L = 0
    while 3 ** L < n:
        L += 1
    if 3 ** L != n:
        raise ValueError(f"the BFS controller needs 3^L agents, got {n}")
    return L


def reference_rewards(c: dict, starts: dict, s_step: int, dev, dtype=torch.float64):
    """The reference's rewards for the kept chunks, in ``dtype``: from each
    chunk's start state, and from every fresh episode the generator gave
    inside it, ``horizon`` steps, or to the chunk's end where that is
    ``end_horizon`` steps or fewer away.  Returns ({chunk: (rewards [T, B],
    mask [T, B] of the entries computed, (rows, state at the chunk's end)
    or None)}, the first chunk's mean reward run whole, with its
    auto-resets, or None where the cell does not ask)."""
    cfg, wl = c["config"], c["workload"]
    n, B, T, K = cfg["num_agents"], wl["num_envs"], wl["chunk"], wl["horizon"]
    w = F.World(n=n, episode_length=cfg["episode_length"])
    L = level_count(n)
    gen = torch.Generator(device=dev).manual_seed(s_step)
    out, whole = {}, None
    drawn = 0  # steps whose fresh episodes the reference's generator has drawn
    for idx in sorted(starts):
        start = starts[idx]
        while drawn < idx * T:  # the draws of the chunks not kept
            F.draw_reset(gen, B, n)
            drawn += 1
        fresh = []
        for _ in range(T):
            fresh.append(F.draw_reset(gen, B, n))
            drawn += 1
        ref = torch.zeros((T, B), dtype=torch.float64, device=dev)
        mask = torch.zeros((T, B), dtype=torch.bool, device=dev)
        t0 = start.t
        # an env starts an episode at step j + 1 of the chunk where its step count wraps at step j
        syncs = [(0, torch.ones(B, dtype=torch.bool, device=dev), start)]
        for j in range(T - 1):
            done = (t0 + j + 1) % w.episode_length == 0
            if bool(done.any()):
                a, s, v = fresh[j]
                syncs.append((j + 1, done, F.State(a, torch.zeros_like(a), s, v, torch.zeros_like(t0))))
        end = None
        for j0, rows, st in syncs:
            idx_rows = rows.nonzero()[:, 0]
            st = st.rows(idx_rows).to(dtype)
            # to the chunk's end where that is near, else the horizon
            stop = T if T - j0 <= wl["end_horizon"] else min(T, j0 + K)
            for j in range(j0, stop):
                npos, nvel, r = F.bfs_step(st, w, L)
                ref[j, idx_rows] = r.double()
                mask[j, idx_rows] = True
                t = st.t + 1
                done = t >= w.episode_length
                if j == T - 1:
                    a, s, v = (x[idx_rows].to(dtype) for x in fresh[j])
                    new = F.State(a, torch.zeros_like(a), s, v, torch.zeros_like(t))
                    end = (idx_rows, F.select(done, new, F.State(npos, nvel, st.ishape, st.ivel, t)))
                elif bool(done.any()):
                    break  # the next step starts another episode
                st = F.State(npos, nvel, st.ishape, st.ivel, t)
        out[idx] = (ref, mask, end)
        if whole is None and wl.get("whole_chunk", False):
            rows = _whole_rows(B, wl["whole_chunk_envs"], s_step, dev)
            whole = _whole_chunk(start.rows(rows), [tuple(x[rows] for x in f) for f in fresh], w, L, dtype)
    return out, whole


def compare(prog: dict, ref: dict, whole_prog, whole_ref, rel: float, ends=None) -> dict:
    """The numbers compared, from the rewards of the kept chunks and
    (``ends``: chunk → the state the program handed on) their end states."""
    ks = sorted(prog)
    p = torch.cat([prog[k].double() for k in ks])
    r = torch.cat([ref[k][0] for k in ks])
    m = torch.cat([ref[k][1] for k in ks])
    out = judge.rollout_numbers(p, r, m, whole_prog, whole_ref, rel)
    if ends is not None:
        pairs = [(ends[k], ref[k][2]) for k in ks if ref[k][2] is not None]
        out["end_mismatch_share"] = judge.state_mismatch_share(
            [(pe.apos[rows], pe.avel[rows], re.apos, re.avel) for pe, (rows, re) in pairs])
    return out


def check(c: dict, kept: dict, s_step: int, dev):
    """The numbers compared, and the reference's rewards."""
    ref, whole = reference_rewards(c, {k: v[0] for k, v in kept.items()}, s_step, dev)
    prog = {k: v[1] for k, v in kept.items()}
    wl = c["workload"]
    whole_prog = None
    if whole is not None:
        rows = _whole_rows(wl["num_envs"], wl["whole_chunk_envs"], s_step, dev)
        whole_prog = float(prog[min(kept)][:, rows].double().mean())
    ends = {k: v[2] for k, v in kept.items()}
    return compare(prog, ref, whole_prog, whole, c["limits"]["reward_rel"], ends), (ref, whole)


def _whole_rows(B: int, k: int, seed: int, dev) -> torch.Tensor:
    """The envs, drawn from the seed, whose first kept chunk the reference
    runs whole."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(B, generator=g)[: min(k, B)].sort().values.to(dev)


def _whole_chunk(start: F.State, fresh, w: F.World, L: int, dtype) -> float:
    """The mean reward of a chunk run whole by the reference, with its
    auto-resets."""
    st = start.to(dtype)
    total = 0.0
    for a, s, v in fresh:
        npos, nvel, r = F.bfs_step(st, w, L)
        total += float(r.double().sum())
        t = st.t + 1
        done = t >= w.episode_length
        new = F.State(a.to(dtype), torch.zeros_like(a, dtype=dtype), s.to(dtype), v.to(dtype), torch.zeros_like(t))
        st = F.select(done, new, F.State(npos, nvel, st.ishape, st.ivel, t))
    return total / (len(fresh) * st.apos.shape[0])
