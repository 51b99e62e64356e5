"""The first iterations of an off-policy learner: mean step reward per iteration.

    python tools/offpolicy_early_rewards.py --impl jax [--algos maddpg,matd3] [--seeds 0,1] [--iters 12]
    python tools/offpolicy_early_rewards.py --impl jax --algos rmaddpg,rmatd3,rmasac,rqmix,rvdn
    python tools/offpolicy_early_rewards.py --impl torch [--device cpu|cuda] ...

Trains each algorithm of ``--algos`` from a fresh learner for ``--iters``
iterations at the reference's zoo protocol (formation_hd_env, N=3, 32 envs,
the config's defaults: for MADDPG hidden (64, 64, 64), batch 256, a buffer
of 500,000, 32 env steps and 32 updates an iteration; the recurrent names
on episodes of 25 steps, 4096 episodes buffered, batches of 32 episodes, 8
collections and 4 updates an iteration) and prints one JSON line per
(algorithm, seed) with each iteration's ``mean_step_reward``.
``--impl jax`` runs the JAX package (``gym_formation_tpu``, float32;
``JAX_PLATFORMS=cpu`` for the CPU), ``--impl torch`` the PyTorch port
(``gym_formation_tpu_torch``); one process imports only one of them.  The
two draw from different random streams, so compare them in distribution
(over seeds), not step by step.  What this shows: how far a learner's
reward moves before it learns, which bounds what a short run on the card
can be held to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DISCRETE_ONLY = ("qmix", "vdn", "rqmix", "rvdn")
EPISODIC = ("rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn")


def env_kwargs(name):
    """The zoo protocol's env: the recurrent names train on episodes of 25
    steps (RESULTS.md, "Recurrent algorithm zoo")."""
    return dict(discrete_action=name in DISCRETE_ONLY, **({"episode_length": 25} if name in EPISODIC else {}))


def run_jax(name, seed, iters):
    import jax

    import gym_formation_tpu as ft
    from gym_formation_tpu.algos import registry

    env = ft.make_env("formation_hd_env", num_agents=3, **env_kwargs(name))
    algo = registry.make_algo(name, env, num_envs=32)
    state = algo.init(jax.random.PRNGKey(seed))
    rewards = []
    for i in range(iters):
        *state, m = algo.train_step(*state, jax.random.fold_in(jax.random.PRNGKey(seed), i))
        rewards.append(float(m["mean_step_reward"]))
    return rewards


def run_torch(name, seed, iters, device):
    import torch

    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import make_algo

    env = gt.make_env("formation_hd_env", num_agents=3, **env_kwargs(name))
    algo = make_algo(name, env, 32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    state = algo.init(g)
    rewards = []
    for _ in range(iters):
        *state, m = algo.train_step(*state, g)
        rewards.append(float(m["mean_step_reward"]))
    return rewards


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--impl", choices=["jax", "torch"], required=True)
    p.add_argument("--algos", default="maddpg,ddpg,matd3,masac,qmix,vdn")
    p.add_argument("--seeds", default="0,1")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--device", default="cpu", help="the port's device (--impl torch)")
    args = p.parse_args()
    for name in args.algos.split(","):
        for seed in map(int, args.seeds.split(",")):
            t0 = time.perf_counter()
            rewards = (run_jax(name, seed, args.iters) if args.impl == "jax"
                       else run_torch(name, seed, args.iters, args.device))
            print(json.dumps({"impl": args.impl, "algo": name, "seed": seed, "mean_step_reward": rewards,
                              "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
