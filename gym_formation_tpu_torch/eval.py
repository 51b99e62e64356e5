"""Evaluation entry point of the port: a checkpoint of ``train``, or the
scripted ezpolicy, run for a few episodes, with per-episode returns and the
benchmark quartet.

    python -m gym_formation_tpu_torch.eval --policy ckpt --algo rmappo --ckpt runs/<run>/ckpt
    python -m gym_formation_tpu_torch.eval --policy ckpt --algo qmix --ckpt runs/<run>/ckpt
    python -m gym_formation_tpu_torch.eval --policy ckpt --algo rmaddpg --ckpt runs/<run>/ckpt --episode-length 25
    python -m gym_formation_tpu_torch.eval --policy ckpt --ckpt runs/<run>/ckpt --num-layer 2
    python -m gym_formation_tpu_torch.eval --policy ezpolicy --num-agents 3 --num-layer 2
    python -m gym_formation_tpu_torch.eval --device cpu --episodes 1

The arguments and refusals are those of the JAX package's root ``eval.py``,
plus ``--device`` (default ``cuda``).  The learner is built from the
checkpoint's own config.  ``--num-layer L`` expands an n-agent policy over
n^L agents through the BFS hierarchy: of the checkpoints, only a
shared-policy MAPPO one can be expanded.  ``--gif`` and
``--per-agent-view`` stop: the renderer is not yet ported.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import ALGO_NAMES, DISCRETE_ONLY, eval_policy, make_algo
from gym_formation_tpu_torch.utils import restore_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scenario", default="formation_hd_env")
    p.add_argument("--num-agents", type=int, default=3, help="policy arity n")
    p.add_argument("--num-layer", type=int, default=1, help="BFS hierarchy depth")
    p.add_argument("--policy", choices=["ckpt", "ezpolicy"], default="ezpolicy")
    p.add_argument("--algo", choices=ALGO_NAMES, default="mappo",
                   help="algorithm the checkpoint was trained with (--policy ckpt)")
    p.add_argument("--ckpt", default=None, help="checkpoint dir written by train (<run-dir>/ckpt)")
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--episode-length", type=int, default=None)
    p.add_argument("--gif", default=None)
    p.add_argument("--per-agent-view", action="store_true")
    p.add_argument("--no-clip", action="store_true",
                   help="don't clip continuous checkpoint actions to the ±1 control range")
    p.add_argument("--stochastic", action="store_true",
                   help="sample the policy distribution instead of its mode (mappo checkpoints), "
                   "from a generator seeded by --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--discrete-action", action="store_true",
                   help="checkpoint was trained with train --discrete-action")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


NO_BFS_CKPT = ("--num-layer > 1 with a checkpoint requires a shared stateless actor (mappo): per-agent stacked "
               "actors have no meta-agent assignment and recurrent actors have no per-group hidden state")


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.gif or args.per_agent_view:
        raise SystemExit("--gif and --per-agent-view: the renderer is not yet ported")
    n = args.num_agents
    total = n ** args.num_layer
    discrete = args.discrete_action or (args.policy == "ckpt" and args.algo in DISCRETE_ONLY)
    if discrete and args.num_layer > 1:
        raise SystemExit("--num-layer > 1 needs continuous velocity actions (the BFS hierarchy feeds "
                         "target velocities to sub-groups); discrete policies can't be BFS-expanded")
    if args.discrete_action and args.policy != "ckpt":
        raise SystemExit("--discrete-action only applies to trained checkpoints (--policy ckpt): the "
                         "scripted policies emit 2-dim velocities, not 5-way one-hots")
    if args.stochastic and (args.policy != "ckpt" or args.num_layer > 1):
        raise SystemExit("--stochastic applies to direct (--num-layer 1) mappo checkpoint evals: the "
                         "BFS expansion feeds deterministic meta-velocities")
    if args.num_layer > 1 and args.policy == "ckpt" and args.algo != "mappo":
        raise SystemExit(NO_BFS_CKPT)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: evaluate on the CPU with --device cpu")
    tree = None
    if args.policy == "ckpt":
        if not args.ckpt:
            raise SystemExit("--ckpt is required with --policy ckpt")
        tree = restore_checkpoint(args.ckpt)
        if args.num_layer > 1 and not tree["config"]["share_policy"]:
            raise SystemExit(NO_BFS_CKPT)

    kw = {}
    if args.episode_length is not None:
        kw["episode_length" if args.scenario == "formation_hd_env" else "world_length"] = args.episode_length
    env = gt.make_env(args.scenario, num_agents=total, benchmark=True, auto_reset=False,
                      discrete_action=discrete, **kw)
    use_bfs = args.num_layer > 1 and args.scenario == "formation_hd_env"

    carry0, ckpt_policy = None, None
    if tree is not None:
        proto_env = gt.make_env(args.scenario, num_agents=n, discrete_action=discrete, **kw)
        # the learner's config as it was trained (per-agent networks, widths)
        algo = make_algo(args.algo, proto_env, num_envs=1, device=device, config=tree["config"])
        ts = algo.state_from_tree(tree)
        # batch of one env: observations [1, N, obs_dim]
        ckpt_policy, carry0 = eval_policy(args.algo, algo, ts, batch_size=1,
                                          clip_continuous=not args.no_clip,
                                          stochastic=args.stochastic, seed=args.seed)

        def base_policy(rows):  # [M, 6n] → [M, 2], the stateless actor the BFS expands
            return ckpt_policy(rows[None], None)[0][0]

    elif args.scenario == "formation_hd_env":
        base_policy = gt.ezpolicy_batched
    else:
        # ezpolicy reads the hd observation layout; other scenarios get random actions
        print(f"note: ezpolicy is formation_hd-specific; using random actions for {args.scenario}")
        rand = torch.Generator(device=device)
        rand.manual_seed(args.seed + 10_000)

        def base_policy(rows):
            u = torch.rand(rows.shape[:-1] + (env.act_dim,), generator=rand, device=device)
            return u * 2.0 - 1.0

    def act(obs, carry):
        if ckpt_policy is not None and not use_bfs:
            return ckpt_policy(obs, carry)
        if use_bfs:
            return gt.bfs_actions(base_policy, obs, n), carry
        return base_policy(obs.reshape(-1, obs.shape[-1])).reshape(obs.shape[:2] + (-1,)), carry

    returns = []
    for ep in range(args.episodes):
        g = torch.Generator(device=device)
        g.manual_seed(args.seed + ep)
        state, obs = env.reset(g, 1)
        carry, done, total_r, t = carry0, False, 0.0, 0
        while not done:
            actions, carry = act(obs, carry)
            state, out = env.step(state, actions, g)
            obs = out.obs
            total_r += float(out.reward[0, 0])
            done = bool(out.done.all())
            t += 1
        returns.append(total_r)
        bench = {k: float(v.mean()) for k, v in out.info.items()}
        print(f"episode {ep}: return={total_r:.2f} len={t} bench={bench}")
    print(f"mean return over {args.episodes} episodes: {np.mean(returns):.3f} ± {np.std(returns):.3f}")


if __name__ == "__main__":
    main()
