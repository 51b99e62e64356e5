"""MAPPO training traffic: ``MAPPO.train_step`` back to back.

The workload gives ``num_envs``, ``fetch_every`` (the iterations between host
fetches of an iteration's metrics, as a training loop logs them),
``initial_step`` (where the first episodes stand), the learner's options
(``mappo``) and the reference's rows a block (``reference_block_rows``).
Set-up builds one learner and one training state from the seed, drives
them through three iterations (which warm every shape the window uses) and
hands the same objects to the window.  The reference follows those three
iterations after the window has closed.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from perfbench import counts, harness, judge
from perfbench.drivers import common
from perfbench.reference import formation as F
from perfbench.reference import mappo as R

WARM_ITERS = 3


def _learner(c: dict, device, mesh=None):
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos.mappo import MAPPO, MAPPOConfig

    cfg, wl = c["config"], c["workload"]
    env = gt.make_env(cfg["scenario"], num_agents=cfg["num_agents"], episode_length=cfg["episode_length"],
                      mesh=mesh)
    mcfg = MAPPOConfig(**dict(cfg["mappo"], hidden=tuple(cfg["mappo"]["hidden"]), **wl["mappo"]))
    learner = MAPPO(env, mcfg, num_envs=wl["num_envs"], device=device)
    for flag, want in wl.get("paths", {}).items():
        if getattr(learner, flag) != want:
            raise RuntimeError(f"the learner took {flag}={getattr(learner, flag)}, the cell states {want}")
    return learner


def _fetch(m: dict) -> torch.Tensor:
    return torch.stack([v.detach().float() for v in m.values()]).cpu()


def _timed(fn, clock, spans, label):
    """``fn`` with a span of stamps around each call (a trace run's
    collection and update) and a profiler label."""
    def wrapped(*a, **k):
        with torch.profiler.record_function(label):
            s = clock.stamp()
            out = fn(*a, **k)
            spans.append((s, clock.stamp()))
        return out
    return wrapped


def run(c: dict, seed: int, seconds: float, trace: bool, device: str, t0: float, fault=None,
        control: bool = False) -> dict:
    """One run of a training cell.  ``fault`` (the tests' and the
    calibration's) is applied to the learner before set-up; ``control``
    adds the lower-precision control's numbers under ``control``.  A cell
    on several chips runs a data-parallel world, this process its rank 0."""
    if int(c["workload"].get("chips", 1)) > 1:
        return _world(c, seed, seconds, trace, device, t0, fault, control)
    return _train(c, seed, seconds, trace, device, t0, fault, control, None)


def _world(c, seed, seconds, trace, device, t0, fault, control):
    """Ranks 1 .. W-1 in new processes, rank 0 here, one card each (or
    gloo on the CPU), joined on a free localhost port."""
    import socket

    import torch.distributed as dist
    import torch.multiprocessing as mp

    W = int(c["workload"]["chips"])
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    kids = mp.start_processes(_rank_main, args=(W, port, c, seed, seconds, trace, device, fault),
                              nprocs=W - 1, join=False, start_method="spawn")
    try:
        mesh = _join(0, W, port, device)
        try:
            return _train(c, seed, seconds, trace, device, t0, fault, control, mesh)
        finally:
            dist.destroy_process_group()
    finally:
        while not kids.join():
            pass


def _join(rank: int, W: int, port: int, device: str):
    from gym_formation_tpu_torch import parallel

    device_type = "cuda" if device != "cpu" else "cpu"
    parallel.initialize_multihost(f"127.0.0.1:{port}", W, rank, None, device_type)
    return parallel.pod_mesh(1, device_type)


def _rank_main(i: int, W, port, c, seed, seconds, trace, device, fault):
    """Rank i + 1 of the world: the same run, reporting nothing."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    mesh = _join(i + 1, W, port, device)
    try:
        _train(c, seed, seconds, trace, device, time.perf_counter(), fault, False, mesh)
    finally:
        dist.destroy_process_group()


def _train(c, seed, seconds, trace, device, t0, fault, control, mesh) -> dict:
    import torch.distributed as dist
    from gym_formation_tpu_torch.parallel import mesh as dp

    cfg, wl = c["config"], c["workload"]
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rank, W = dp.rank(mesh), dp.size(mesh)
    n, B, hidden = cfg["num_agents"], wl["num_envs"], cfg["mappo"]["hidden"]
    s_w, s_env, s_step, s_k5 = harness.seeds(seed)
    g = lambda s: torch.Generator(device=dev).manual_seed(s)

    marks = [("start", t0), ("imports", time.perf_counter())]
    learner = _learner(c, dev, mesh)
    if fault is not None:
        fault(learner)
    weights = common.make_weights(n, hidden, g(s_w))
    ts = learner.init_state(*common.program_networks(weights, n, hidden, dev))
    learner.seed_generator.manual_seed(s_k5)
    es, ref_state = common.first_episodes(n, B, wl["initial_step"], g(s_env))
    marks.append(("learner, weights, episodes", time.perf_counter()))
    if mesh is not None:  # the rank's rows of the global episodes
        b = B // W
        es = dataclasses.replace(es, **{f.name: getattr(es, f.name)[rank * b:(rank + 1) * b].contiguous()
                                        for f in dataclasses.fields(es)})
    gen = g(s_step)
    names = [f"actor.{k}" for k, _ in ts.actor.named_parameters()] + \
            [f"critic.{k}" for k, _ in ts.critic.named_parameters()]
    if trace and dev.type == "cuda":
        harness.Profiled.warm()

    # the three iterations the reference follows, which warm every shape
    follow_steps = wl.get("follow", "whole") == "steps"
    collected, opt_steps = [], []
    if follow_steps:
        collect_name = _collect_name(learner)
        setattr(learner, collect_name, _capturing(getattr(learner, collect_name), collected))
        if rank == 0:
            _capturing_steps(learner, names, opt_steps, learner.cfg.ppo_epochs)
    obs, warm = None, []
    for i in range(WARM_ITERS):
        ts, es, obs, m = learner.train_step(ts, es, obs, gen)
        warm.append((list(m), m))
        if i == 0:
            mu1 = dict(zip(names, ts.opt_state.mu))
    theta3 = {k: p.detach().clone() for k, p in zip(names, ts.params())}
    if follow_steps:
        for attr in (collect_name, "_apply", "_reduce"):
            learner.__dict__.pop(attr, None)
    warm = [dict(zip(keys, _fetch(m).tolist())) for keys, m in warm]
    common.sync(dev)
    marks.append(("three iterations", time.perf_counter()))
    common.report_setup(marks)

    clock = common.Clock(dev)
    spans = {"collect": [], "update": []}
    if trace:
        collect_name = _collect_name(learner)
        update_name = "_update_fused" if learner.cfg.fused_update else "_update"
        setattr(learner, collect_name, _timed(getattr(learner, collect_name), clock, spans["collect"], "collect"))
        setattr(learner, update_name, _timed(getattr(learner, update_name), clock, spans["update"], "update"))
        dp.reset_stats(timing=mesh is not None)
    kmods = _kernel_modules()
    prof, launches0 = None, None
    profile_after = max(0.0, seconds - float(wl.get("profile_seconds", 3.0)))

    # -- the window ---------------------------------------------------------------------
    # one process stops on its own clock; a world stops where rank 0's clock
    # says, told at the host fetches, which wait for the card anyway
    if mesh is not None:
        dist.barrier()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    stamps = [clock.stamp()]
    iters = failed = 0
    m = None
    stop = False
    while not stop:
        ts, es, obs, m = learner.train_step(ts, es, obs, gen)
        stamps.append(clock.stamp())
        iters += 1
        now = time.perf_counter() - t_start
        if iters % wl["fetch_every"] == 0:
            failed += int(not torch.isfinite(_fetch(m)).all())
            if mesh is not None:
                flag = torch.tensor([float(now >= seconds)], device=dev)
                dist.broadcast(flag, src=0)
                stop = bool(flag.item())
        if mesh is None:
            stop = now >= seconds
        if trace and prof is None and now >= profile_after and dev.type == "cuda" and not stop:
            prof = harness.Profiled()
            prof.start()
            launches0 = {k: mod.launches for k, mod in kmods.items()}
    if iters % wl["fetch_every"]:
        failed += int(not torch.isfinite(_fetch(m)).all())
    window_s = time.perf_counter() - t_start
    common.sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    allreduce_ms = dp.collective_ms(("all_reduce",)) / iters if (trace and mesh is not None) else None
    tr, launches = None, None
    if prof is not None:
        launches = {k: mod.launches - launches0[k] for k, mod in kmods.items()}
        tr = prof.stop(harness.ROOT / "build" / "perfbench" / f"{c['name']}.{seed}.{rank}.trace.json")
    tctx = harness.trace_context(tr)
    if mesh is not None:
        # the fullest card's peak, the cards' mean busy time, every rank's collections
        peak_t = torch.tensor([float(peak)], device=dev)
        dist.all_reduce(peak_t, op=dist.ReduceOp.MAX)
        peak = int(peak_t.item())
        busy = [None] * W
        dist.all_gather_object(busy, tctx.get("busy_s"))
        if tctx.get("trace") is not None and all(v is not None for v in busy):
            tctx["busy_s"] = sum(busy) / W
        if follow_steps:
            parts = [None] * W if rank == 0 else None
            dist.gather_object(collected, parts, dst=0)
            collected = _merge(parts) if rank == 0 else None
        if rank:
            return {}

    iter_ms = harness.interval_durations([clock.elapsed(stamps[0], s) for s in stamps])
    steps = iters * B * cfg["mappo"]["rollout_len"]
    e2e = dict(setup_s=setup_s, train_env_steps_per_s=harness.rate(steps, window_s),
               iter_ms_p95=harness.percentile(iter_ms, 95))
    factorized = bool(learner.structured_obs)
    ops_iter = counts.iteration_ops(n, B, cfg["mappo"]["rollout_len"], cfg["mappo"]["ppo_epochs"], factorized)
    ctx = dict(tctx, kind="train", n=n, B=B // W, T=cfg["mappo"]["rollout_len"],
               window_s=window_s, iterations=iters, launches=launches, allreduce_ms=allreduce_ms,
               collect_ms=[clock.elapsed(a, b) for a, b in spans["collect"]],
               update_ms=[clock.elapsed(a, b) for a, b in spans["update"]],
               mfu=100.0 * ops_iter * iters / (window_s * counts.FP32_OPS_PER_S * W),
               peak_bytes=peak)

    # -- the check, once the program's state is freed -------------------------------------
    prog_losses = [judge.total_loss(v, cfg["mappo"]["entropy_coef"], cfg["mappo"]["value_coef"]) for v in warm]
    prog_rewards = [v["mean_step_reward"] for v in warm]
    prog_mu1 = {k: v.detach().double() for k, v in mu1.items()}
    prog_change = {k: theta3[k].double() - weights[k].double() for k in names}
    del learner, ts, es, obs, m, mu1, theta3
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if follow_steps:
        ref = reference(c, weights, ref_state, s_step, s_k5, dev, collected=(collected, opt_steps))
        numbers = steps_numbers(c, opt_steps, ref, weights, names)
    else:
        ref = reference(c, weights, ref_state, s_step, s_k5, dev)
        ref_change = {k: ref["theta"][k] - weights[k].double() for k in names}
        numbers = judge.training_numbers(prog_losses, ref["losses"], prog_mu1, ref["mu1"], prog_change, ref_change)
        numbers["reward_gap"] = judge.rel_gap(prog_rewards, ref["rewards"])
    numbers["reference_s"] = time.perf_counter() - t_ref
    correct, checks = harness.checks_block(numbers, c["limits"]["limits"])
    out = dict(e2e=e2e, ctx=ctx, correct=correct and failed == 0, attempted=iters, failed=failed,
               checks=checks, device=common.device_info(dev, peak, W), numbers=numbers)
    if control:
        out["control"] = control_numbers(c, weights, ref_state, s_step, s_k5, dev, ref, names, follow_steps)
    return out


def steps_numbers(c, prog_steps, ref, weights, names) -> dict:
    """The numbers of a cell that follows the program step by step: the
    recorded optimizer steps' losses, each iteration's first gradient, the
    change over the first three steps, and the collection's gaps."""
    mc = c["config"]["mappo"]
    ce, vc = mc["entropy_coef"], mc["value_coef"]
    # each iteration's first step (the first three of the first iteration
    # are recorded; its second and third are reported, not compared)
    firsts = [rec[0][2] for rec in prog_steps]
    later = [met for _, g, met in prog_steps[0][1:] if g is not None]
    loss = lambda p, r: abs(judge.total_loss(p, ce, vc) - judge.total_loss(r, ce, vc)) / judge.loss_scale(r, ce, vc)
    host = lambda d: {k: v.detach().double().cpu() for k, v in d.items()}
    grad = max(judge.leaf_gap(host(rec[0][1]), host(r)) for rec, r in zip(prog_steps, ref["grads"]))
    w0 = host(weights)
    change = {k: v - w0[k] for k, v in host(prog_steps[0][-1][0]).items()}
    ref_change = {k: v - w0[k] for k, v in host(ref["theta3"]).items()}
    moving = judge.moving_leaves(host(ref["grads"][0]))
    return dict(loss_gap=max(loss(p, r) for p, r in zip(firsts, ref["first_mets"])),
                leaves_left_out=float(len(ref["grads"][0]) - len(moving)),
                loss_gap_later=max(loss(p, r) for p, r in zip(later, ref["later_mets"])), grad_gap=grad,
                change_gap=judge.leaf_gap(change, ref_change, moving),
                reward_gap=max(ref["reward"]), policy_gap=ref["gaps"]["policy"],
                state_gap=ref["gaps"]["state"], done_gap=ref["gaps"]["done"])


def control_numbers(c, weights, state, s_step, s_k5, dev, ref, names, follow_steps) -> dict:
    """The numbers the control gives: the reference in float32 with TF32
    products, in the program's place.  Where the cell follows the program
    step by step, the float64 reference follows the control's own
    collections and optimizer steps."""
    ctl = reference(c, weights, state, s_step, s_k5, dev, dtype=torch.float32, tf32=True, capture=follow_steps)
    if follow_steps:
        judge_ref = reference(c, weights, state, s_step, s_k5, dev, collected=ctl["captured"])
        return steps_numbers(c, ctl["captured"][1], judge_ref, weights, names)
    change = lambda r: {k: r["theta"][k] - weights[k].double() for k in names}
    numbers = judge.training_numbers(ctl["losses"], ref["losses"], ctl["mu1"], ref["mu1"], change(ctl), change(ref))
    numbers["reward_gap"] = judge.rel_gap(ctl["rewards"], ref["rewards"])
    return numbers


def _merge(parts):
    """The ranks' collections as one process's: states along the envs,
    trajectories along their second (env) axis."""
    out = []
    for k in range(len(parts[0])):
        its = [p[k] for p in parts]
        cat = lambda xs, d: torch.cat(xs, d)
        st = lambda i: F.State(*(cat([getattr(x[i], f.name) for x in its], 0) for f in dataclasses.fields(F.State)))
        traj = {key: cat([x[1][key] for x in its], 1) for key in its[0][1]}
        out.append((st(0), traj, cat([x[2] for x in its], 0), st(3)))
    return out


def _collect_name(learner) -> str:
    return ("_collect_structured" if learner.structured_obs else
            "_collect_fused" if learner.fused_collect else "_collect")


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True)


def _parts_cpu(es, n: int) -> F.State:
    return F.State(_host(es.pos[:, :n]), _host(es.vel[:, :n]), _host(es.ideal_shape), _host(es.ideal_vel),
                   _host(es.t).to(torch.int64))


def _capturing(fn, out: list):
    """The collection, its input and output states, trajectory and last
    value copied to the host as it returns them (set-up only)."""
    def wrapped(ts, env_state, obs, generator):
        res = fn(ts, env_state, obs, generator)
        es_out, _, traj, _, last_value = res
        n = env_state.ideal_shape.shape[1]
        out.append((_parts_cpu(env_state, n), {k: _host(v) for k, v in traj.items()}, _host(last_value),
                    _parts_cpu(es_out, n)))
        return res
    return wrapped


def _capturing_steps(learner, names, out: list, epochs: int):
    """The optimizer's steps of the three iterations copied to the host
    (set-up only): per iteration (parameters before, the gradient as the
    optimizer gets it, the epoch's losses) of its first epoch, of the first
    three in the first iteration, then the parameters after them."""
    reduce, apply = learner._reduce, learner._apply
    last, calls = {}, [0]

    def reduced(grads, met, whole=("alpha",)):
        grads, met = reduce(grads, met, whole)
        last["met"] = met
        return grads, met

    def applied(ts, grads):
        it, e = divmod(calls[0], epochs)
        calls[0] += 1
        keep = 3 if it == 0 else 1
        params = lambda: {k: p.detach().to("cpu", copy=True) for k, p in zip(names, ts.params())}
        if e < keep:
            if e == 0:
                out.append([])
            met = {k: float(v) for k, v in last["met"].items()}
            out[-1].append((params(), {k: g.detach().to("cpu", copy=True) for k, g in zip(names, grads)}, met))
        apply(ts, grads)
        if e + 1 == keep:
            out[-1].append((params(), None, None))
    learner._reduce, learner._apply = reduced, applied


def _kernel_modules():
    from gym_formation_tpu_torch.ops.kernels import (fused_collect, fused_ppo_grad, pairforce_sym,
                                                     reward_sym)
    return dict(fused_collect=fused_collect, fused_ppo_grad=fused_ppo_grad,
                pairforce_sym=pairforce_sym, reward_sym=reward_sym)


def noise_for(c: dict, s_step: int, s_k5: int, dev, B: int):
    """The draws the program's collection consumes, made again from the
    seeds: the counter PRNG keyed by the learner's per-iteration seeds
    (fused collection), or the step generator's normals and resets."""
    n = c["config"]["num_agents"]
    if c["workload"]["mappo"].get("fused_collect"):
        cpu = torch.Generator().manual_seed(s_k5)
        iter_seeds = [int(torch.randint(0, 2 ** 31 - 1, (1,), generator=cpu)) for _ in range(WARM_ITERS)]
        return R.HashNoise(iter_seeds, B, n, dev)
    return R.GeneratorNoise(torch.Generator(device=dev).manual_seed(s_step), B, n)


def reference(c: dict, weights, state: F.State, s_step: int, s_k5: int, dev, dtype=torch.float64,
              tf32: bool = False, collected=None, capture: bool = False) -> dict:
    """The reference's three iterations from the same weights, episodes and
    seeds, in ``dtype`` (with TF32 products where ``tf32``: the control).
    With ``collected`` (the program's collections and optimizer steps,
    where the cell follows the program step by step) it follows those
    instead (:func:`~perfbench.reference.mappo.train_on`).  With
    ``capture`` the result holds the reference's own collections and
    optimizer steps (``captured``), for the control."""
    cfg, wl = c["config"], c["workload"]
    mc = cfg["mappo"]
    ppo = R.PPO(**{f.name: mc[f.name] for f in dataclasses.fields(R.PPO) if f.name in mc})
    w = F.World(n=cfg["num_agents"], episode_length=cfg["episode_length"])
    noise = noise_for(c, s_step, s_k5, dev, wl["num_envs"])
    factorized = bool(wl.get("paths", {}).get("structured_obs", False))
    rows = wl.get("reference_block_rows", 1 << 14)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        if collected is not None:
            return R.train_on(weights, *collected, w, ppo, noise, factorized, dtype, rows, dev)
        cap, steps = ([], []) if capture else (None, None)
        losses, mu1, theta = R.train(weights, state, w, ppo, noise, WARM_ITERS, factorized, dtype, rows, cap, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return dict(losses=[m["loss"] for m in losses], rewards=[m["mean_step_reward"] for m in losses],
                mu1={k: v.double() for k, v in mu1.items()}, theta={k: v.double() for k, v in theta.items()},
                captured=(cap, steps) if capture else None)
