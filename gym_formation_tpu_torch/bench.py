"""Headline benchmark of the port: env-steps/s at 4096 parallel envs.

    python -m gym_formation_tpu_torch.bench                  # the SUITE, on the card
    python -m gym_formation_tpu_torch.bench --num-agents 243 --policy bfs_state
    python -m gym_formation_tpu_torch.bench --device cpu --num-envs 512 --chunk 8 --iters 1
    python -m gym_formation_tpu_torch.bench --mesh 4 --num-agents 243 --policy bfs_state

Counterpart of the JAX package's root ``bench.py``, with its flags, its
JSON line and its SUITE.  With no arguments it runs the three rows of
:data:`SUITE` in order; with any argument, the one row the flags describe.
Each row prints ONE JSON line (:func:`emit`): the median env-steps/s of
``--windows`` timed windows as ``value``, their min and max beside it.

A row is a chunk of ``--chunk`` env steps of ``--num-envs`` envs, called
``--iters`` times a window after one warm-up chunk.  Every window ends with
a host fetch of the last chunk's reward sum and a finiteness check: only
the fetch proves that the card ran the chunks.  The rows' paths:

- the whole-rollout kernel K4 (:func:`k4_chunk`): ``formation_hd_env``
  under ezpolicy, one ``fused_rollout_hd`` launch a chunk, ``max(iters,
  64)`` chunks a window;
- ``--policy bfs_state`` (:func:`statepolicy_chunk`): the hierarchical
  controller read from the state, on the card through the fused step
  kernel K3 (``rollout_statepolicy_fused``, the BFS in the kernel at arity
  3) and the masked K2, else the step path
  (``rollout_statepolicy_rewardsum``);
- the observation policies ``ezpolicy``, ``bfs``, ``random`` and ``linear``
  (:func:`obs_chunk`): the env step with its observation, each env's reward
  summed and nothing else kept.

``--device`` picks the card (default ``cuda``; without one the run stops)
or the CPU, where every kernel wrapper runs its plain version.  The JAX
package's ``--pallas`` has no counterpart: the tensor's device decides.
``--mesh DP`` spawns DP processes, one card each (``nccl``; ``gloo`` on the
CPU), each stepping ``--num-envs``/DP envs, every draw made at the global
shape (:mod:`gym_formation_tpu_torch.parallel`); rank 0 prints the global
rate.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import numpy as np
import torch

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import _device, parallel
from gym_formation_tpu_torch.ops.kernels import fused_rollout
from gym_formation_tpu_torch.parallel import mesh as dp

BASELINE_STEPS_PER_SEC = 1_000_000.0

# The rows of the no-args run, in order: the N=3 headline (K4), the N=243
# hierarchy (K3 with the in-kernel BFS and the masked K2), basic_formation
# (the step path, K1).
SUITE = (
    {},
    {"num_agents": 243, "policy": "bfs_state"},
    {"scenario": "basic_formation_env"},
)

POLICIES = ("ezpolicy", "random", "bfs", "bfs_state", "linear")


def emit(metric, window_rates):
    """One JSON line: the median of the timed windows as ``value``, their
    min and max as the spread."""
    med = statistics.median(window_rates)
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(med, 1),
                "unit": "env-steps/s",
                "vs_baseline": round(med / BASELINE_STEPS_PER_SEC, 3),
                "windows": len(window_rates),
                "min": round(min(window_rates), 1),
                "max": round(max(window_rates), 1),
            }
        ),
        flush=True,
    )


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scenario", default="formation_hd_env")
    p.add_argument("--num-agents", type=int, default=3)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=256, help="env steps per timed call")
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--windows", type=int, default=3,
                   help="timed windows per run; the JSON reports their median as `value` plus min/max")
    p.add_argument("--mesh", type=int, default=None, metavar="DP",
                   help="split the env batch over DP processes (one card each; gloo on the CPU); "
                   "default: one process")
    p.add_argument("--fused", choices=["auto", "on", "off"], default="auto",
                   help="the whole-rollout kernel K4 (ops/kernels/fused_rollout.py). auto: on for "
                   "formation_hd_env + ezpolicy, one process, a card and --num-envs a multiple of 512")
    p.add_argument("--step-kernel", choices=["auto", "fused", "plain"], default="auto",
                   help="bfs_state only: the fused step kernel K3 (rollout_statepolicy_fused). auto: on "
                   "for formation_hd_env on a card")
    p.add_argument("--policy", choices=POLICIES, default="ezpolicy",
                   help="ezpolicy: the scripted policy on the observations; bfs: its hierarchical "
                   "expansion; bfs_state: the same expansion fed from the state (no [N, 6N] "
                   "observation); linear: clip(obs @ W, -1, 1) with a fixed random W, for scenarios "
                   "whose observation ezpolicy cannot parse; random: uniform actions")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


# -- the rows' chunks ------------------------------------------------------------

def k4_chunk(env, soa, seed, length, mesh=None):
    """``length`` steps of every env in one K4 call.  ``soa``: the
    :class:`~.ops.kernels.fused_rollout.SoAState` of this rank's envs.
    Under a mesh each rank offsets the seed by 7919 a rank, since the
    kernel numbers its envs from 0 on every rank.  Returns ``(soa, reward
    sums [B])``."""
    return fused_rollout.fused_rollout_hd(
        soa, seed + dp.rank(mesh) * 7919, length=length, ep_len=env.world_length, n=env.num_agents)


def statepolicy_chunk(env, state, generator, length, policy_fn, kernel=None, mesh=None):
    """``length`` steps under the state policy ``policy_fn(state,
    generator)``.  ``kernel``: None for the step path
    (``rollout_statepolicy_rewardsum``), else the policy of the fused step
    kernel K3, ``"bfs_ez"`` (the arity-3 BFS in the kernel; ``policy_fn``
    unused) or ``"external"``; under a mesh the sharded fused rollout.
    Returns ``(state, rewards)``, summed over agents: each env's sum over
    the steps [B] on the step path, each step's [T, B] on the fused route."""
    if kernel is None:
        return gt.rollout_statepolicy_rewardsum(env, policy_fn, state, generator, length)
    if mesh is None:
        return gt.rollout_statepolicy_fused(env, policy_fn, state, generator, length, policy=kernel)
    return gt.rollout_statepolicy_fused_sharded(env, policy_fn, state, generator, length, mesh, policy=kernel)


def obs_chunk(env, state, obs, generator, length, policy_fn):
    """``length`` env steps under ``policy_fn(obs, generator)``, keeping only
    each env's reward sum (the steps' outputs are dropped as they come: at
    N=243 a stacked observation would not fit the card).  Returns ``(state,
    obs, reward sums [B])``."""
    acc = torch.zeros(state.pos.shape[0], dtype=state.pos.dtype, device=state.pos.device)
    for _ in range(length):
        state, out = env.step(state, policy_fn(obs, generator), generator)
        obs = out.obs
        acc = acc + out.reward.sum(-1)
    return state, obs, acc


# -- policies ------------------------------------------------------------------------

def bfs_arity(num_agents):
    """The smallest n >= 2 whose power is ``num_agents`` (the BFS arity),
    else ``num_agents`` itself."""
    for cand in range(2, num_agents + 1):
        L = round(np.log(num_agents) / np.log(cand))
        if cand ** max(L, 1) == num_agents:
            return cand
    return num_agents


def linear_weights(obs_dim, act_dim, device, seed=7):
    """The linear policy's W [obs_dim, act_dim]: a normal draw seeded by
    ``seed``, scaled by 1/sqrt(obs_dim)."""
    W = np.random.RandomState(seed).normal(size=(obs_dim, act_dim)) / np.sqrt(obs_dim)
    return torch.as_tensor(W, dtype=torch.float32, device=device)


def make_policy(name, env, device, mesh=None, W=None):
    """The policy of ``--policy name``: ``policy(obs, generator)``, or
    ``policy(state, generator)`` for ``bfs_state``.  ``W``: the linear
    policy's weights (default :func:`linear_weights`)."""
    ez = gt.ezpolicy_batched
    if name == "ezpolicy":
        return lambda obs, g: ez(obs)
    if name == "bfs":
        n = bfs_arity(env.num_agents)
        return lambda obs, g: gt.bfs_actions(ez, obs, n)
    if name == "bfs_state":
        n = bfs_arity(env.num_agents)
        return lambda state, g: gt.bfs_actions_from_state(ez, env.scenario, state, n)
    if name == "linear":
        W = linear_weights(env.scenario.obs_dim, env.act_dim, device) if W is None else W
        return lambda obs, g: torch.clamp(obs @ W, -1.0, 1.0)
    if name == "random":
        def random_policy(obs, g):
            shape = obs.shape[:-1] + (env.act_dim,)
            u = dp.draw_rows(lambda s: torch.rand(s, generator=g, device=g.device, dtype=obs.dtype), shape, mesh)
            return u * 2.0 - 1.0
        return random_policy
    raise ValueError(f"unknown policy {name!r}; one of {POLICIES}")


# -- the row -------------------------------------------------------------------------

def uses_k4(args, device):
    """Whether the row runs K4: ``--fused on``, or ``auto`` for
    formation_hd_env + ezpolicy in one process on a card with the batch a
    multiple of 512; formation_hd_env only."""
    auto = (args.scenario == "formation_hd_env" and args.policy == "ezpolicy" and not args.mesh
            and device.type == "cuda" and args.num_envs % 512 == 0)
    return (args.fused == "on" or (args.fused == "auto" and auto)) and args.scenario == "formation_hd_env"


def step_kernel_policy(args, device):
    """The K3 policy of a ``bfs_state`` row (``"bfs_ez"`` at arity 3,
    ``"external"`` otherwise, with a note), or None for the step path."""
    fused = args.step_kernel == "fused" or (
        args.step_kernel == "auto" and args.scenario == "formation_hd_env" and device.type == "cuda")
    if not fused:
        return None
    n = bfs_arity(args.num_agents)
    if n == 3:
        return "bfs_ez"
    print(f"# non-arity-3 hierarchy (n={n}): in-kernel BFS unavailable, using external expansion",
          file=sys.stderr)
    return "external"


def metric_of(args, k4):
    """The row's metric string, as the JAX package's bench composes it."""
    B = args.num_envs
    if k4:
        return (f"env-steps/s/chip ({args.scenario}, N={args.num_agents}, {B} envs, ezpolicy policy, "
                f"fused rollout kernel)")
    return f"env-steps/s/chip ({args.scenario}, N={args.num_agents}, {B} envs, {args.policy} policy)"


def fetch(r, mesh):
    """The global sum of a chunk's rewards ``r`` on the host: this rank's
    sum, one all_reduce over the ranks, then the copy."""
    return float(dp.all_reduce_(r.detach().sum().reshape(1), mesh)[0])


def run(mesh, args):
    """One row: build the env and its first episodes, warm up with one
    chunk, time ``--windows`` windows, and (rank 0) emit the JSON line.
    Returns ``{"metric", "rates", "sums"}``: the windows' env-steps/s and
    the global reward sums their fetches read."""
    device = _device.resolve(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    env = gt.make_env(args.scenario, num_agents=args.num_agents, mesh=mesh)
    B, T = args.num_envs, args.chunk
    local = dp.per_rank(B, mesh)  # the first episodes are drawn for all B envs, this rank's rows kept
    g = torch.Generator(device=device)
    g.manual_seed(0)
    k4 = uses_k4(args, device)

    if k4:
        if mesh is not None and local % 512:
            raise ValueError(f"K4 under --mesh wants 512 envs a rank per block; got {B}/{dp.size(mesh)}")
        soa = fused_rollout.state_to_soa(env.reset_state(g, local))

        def chunk(seed):
            nonlocal soa
            soa, r = k4_chunk(env, soa, seed, T, mesh)
            return r

        iters = max(args.iters, 64)  # one launch a chunk: amortize the closing fetch
    elif args.policy == "bfs_state":
        policy_fn = make_policy(args.policy, env, device, mesh)
        kernel = step_kernel_policy(args, device)
        state = env.reset_state(g, local)  # no [B, N, 6N] observation is built

        def chunk(seed):
            nonlocal state
            state, r = statepolicy_chunk(env, state, g, T, policy_fn, kernel, mesh)
            return r

        iters = args.iters
    else:
        policy_fn = make_policy(args.policy, env, device, mesh)
        state, obs = env.reset(g, local)

        def chunk(seed):
            nonlocal state, obs
            state, obs, r = obs_chunk(env, state, obs, g, T, policy_fn)
            return r

        iters = args.iters

    rv = fetch(chunk(1), mesh)  # warm-up
    if not math.isfinite(rv):
        raise RuntimeError(f"non-finite reward from the warm-up chunk: {rv}")
    rates, sums, seed = [], [], 2
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = chunk(seed)
            seed += 1
        rv = fetch(r, mesh)  # waits for every chunk of the window
        dt = time.perf_counter() - t0
        if not math.isfinite(rv):
            raise RuntimeError(f"non-finite reward from a timed window: {rv}")
        rates.append(iters * B * T / dt)
        sums.append(rv)
    metric = metric_of(args, k4)
    if dp.rank(mesh) == 0:
        emit(metric, rates)
    return {"metric": metric, "rates": rates, "sums": sums}


def rows(args, argv):
    """The rows to run: the one the flags give, or with no arguments the
    :data:`SUITE`'s, each its overrides on the defaults."""
    if argv:
        return [args]
    out = []
    for overrides in SUITE:
        a = argparse.Namespace(**vars(args))
        for k, v in overrides.items():
            setattr(a, k, v)
        out.append(a)
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run the bench on the CPU with --device cpu")
    for a in rows(args, argv):
        if a.mesh:
            try:
                dp.parse_mesh_arg(str(a.mesh), device.type)
            except ValueError as e:
                raise SystemExit(str(e)) from None
            if a.num_envs % a.mesh:
                raise SystemExit(f"--num-envs {a.num_envs} must divide by the mesh size {a.mesh}")
            parallel.spawn(run, a.mesh, (a,), device_type=device.type)
        else:
            run(None, a)


if __name__ == "__main__":
    main()
