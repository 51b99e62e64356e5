"""Training entry point of the port (the learners on the formation envs).

    python -m gym_formation_tpu_torch.train --algo mappo --scenario formation_hd_env \\
        --num-agents 3 --num-envs 4096 --iters 500
    python -m gym_formation_tpu_torch.train --algo rmappo --num-envs 128 --episode-length 25
    python -m gym_formation_tpu_torch.train --discrete-action --set share_policy=False
    python -m gym_formation_tpu_torch.train --algo masac --num-envs 32 --iters 1000
    python -m gym_formation_tpu_torch.train --algo maddpg --set use_per=True --set ou_noise=True
    python -m gym_formation_tpu_torch.train --algo qmix
    python -m gym_formation_tpu_torch.train --algo rmaddpg --num-envs 32 --episode-length 25 --iters 320
    python -m gym_formation_tpu_torch.train --device cpu --num-envs 8 --iters 2
    python -m gym_formation_tpu_torch.train --restore --run-dir runs/my_run

The arguments are the JAX package's ``train.py`` ones for its 13 algorithms,
plus ``--device`` (default ``cuda``; without a CUDA device the run stops
unless ``--device cpu`` is given).  Every ``--log-every`` iterations one row
of metrics goes to ``<run-dir>/metrics.jsonl``; every ``--save-every``
iterations the whole training tuple goes to ``<run-dir>/ckpt/``, an
off-policy learner's replay buffer included.  The run ends with the
``mean_step_reward`` curve in ``<run-dir>/mean_step_reward.png``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import ALGO_NAMES, DISCRETE_ONLY, EPISODIC, ONPOLICY, make_algo
from gym_formation_tpu_torch.utils import MetricsLogger, latest_step, restore_checkpoint, save_checkpoint

# the algorithms that take --discrete-action (the JAX package's list)
DISCRETE_OK = ("maddpg", "ddpg", "matd3", "masac", "mappo", "rmappo") + DISCRETE_ONLY


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--algo", choices=ALGO_NAMES, default="mappo")
    p.add_argument("--scenario", default="formation_hd_env")
    p.add_argument("--num-agents", type=int, default=3)
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--episode-length", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--set", action="append", metavar="KEY=VALUE", default=[],
                   help="override a field of the algorithm's config, repeatable (e.g. --set ppo_epochs=5)")
    p.add_argument("--config", default=None, help="YAML file of config overrides; --set wins")
    p.add_argument("--discrete-action", action="store_true",
                   help="5-way discrete action env: mappo and rmappo take a categorical head, maddpg/ddpg/matd3/"
                   "masac logits actors")
    p.add_argument("--benchmark", action="store_true",
                   help="build the env with benchmark=True and log the bench_* means")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--restore", action="store_true",
                   help="resume from the latest checkpoint in --run-dir")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def switches(name: str, algo) -> str:
    """The learner family's own switches, for the start-up line."""
    cfg = algo.cfg
    if name in ONPOLICY:
        on = dict(share_policy=cfg.share_policy, fused_collect=algo.fused_collect,
                  structured_obs=algo.structured_obs, fused_update=cfg.fused_update)
    elif name == "masac":
        on = dict(autotune_alpha=cfg.autotune_alpha, warmup_random_steps=cfg.warmup_random_steps)
    elif name == "rmasac":
        on = dict(autotune_alpha=cfg.autotune_alpha)
    elif name in ("rmaddpg", "rmatd3"):
        on = dict(twin=cfg.twin, mask_done=cfg.mask_done)
    elif name in ("rqmix", "rvdn"):
        on = dict(mixer=cfg.mixer, double_q=cfg.double_q)
    elif name in DISCRETE_ONLY:
        on = dict(mixer=cfg.mixer, double_q=cfg.double_q, hard_interval=cfg.hard_interval)
    else:
        on = dict(centralized=cfg.centralized, use_per=cfg.use_per, ou_noise=cfg.ou_noise)
    return " ".join(f"{k}={v}" for k, v in on.items())


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.discrete_action and args.algo not in DISCRETE_OK:
        raise SystemExit("--discrete-action is supported by maddpg/ddpg/matd3/masac (the gumbel-softmax "
                         "paths) and mappo/rmappo (categorical heads); qmix/vdn variants are discrete by default")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: train on the CPU with --device cpu")

    kw = {}
    if args.episode_length is not None:
        kw["episode_length" if args.scenario == "formation_hd_env" else "world_length"] = args.episode_length
    env = gt.make_env(args.scenario, num_agents=args.num_agents, benchmark=args.benchmark,
                      discrete_action=args.discrete_action or args.algo in DISCRETE_ONLY, **kw)
    algo = make_algo(args.algo, env, args.num_envs, args.set, args.config, args.lr, device)
    cfg = algo.cfg

    run_dir = args.run_dir or os.path.join(
        "runs", f"{args.algo}_{args.scenario}_N{args.num_agents}_{int(time.time())}")
    ckpt_dir = os.path.join(run_dir, "ckpt")
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    state = algo.init(generator)  # (ts, env_state, obs[, carry]), (ts, buffer, env_state, obs) or (ts, buffer)
    start = 0
    if args.restore:
        step = latest_step(ckpt_dir)
        if step is None:
            raise SystemExit(f"--restore: no checkpoint under {ckpt_dir} (pass the run's --run-dir)")
        state = algo.restore_tree(restore_checkpoint(ckpt_dir, step), generator)
        start = step
        print(f"restored checkpoint at iteration {step} from {ckpt_dir}")

    print(f"{args.algo} on {args.scenario} N={args.num_agents} B={args.num_envs} device={device} "
          f"discrete={algo.discrete}: {switches(args.algo, algo)}")
    if args.algo in ONPOLICY:
        steps_per_iter = cfg.rollout_len * args.num_envs
    elif args.algo in EPISODIC:
        steps_per_iter = cfg.episodes_per_iter * args.num_envs * env.world_length
    else:
        steps_per_iter = cfg.steps_per_iter * args.num_envs
    logger = MetricsLogger(run_dir)
    for i in range(start, start + args.iters):
        *state, m = algo.train_step(*state, generator)
        if (i - start) % args.log_every == 0:
            m = {k: float(v) for k, v in m.items()}
            logger.log((i + 1) * steps_per_iter, m)
            print(f"iter {i}: {m}")
        if args.save_every and (i + 1 - start) % args.save_every == 0:
            save_checkpoint(ckpt_dir, i + 1, algo.checkpoint_tree(*state, generator), max_to_keep=2)
    logger.plot("mean_step_reward")
    logger.close()
    print(f"done -> {run_dir}")


if __name__ == "__main__":
    main()
