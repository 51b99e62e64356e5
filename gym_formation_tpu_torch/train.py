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
    python -m gym_formation_tpu_torch.train --mesh 4 --num-agents 243 --num-envs 1024
    python -m gym_formation_tpu_torch.train --mesh 2 --device cpu --num-envs 8 --iters 2
    python -m gym_formation_tpu_torch.train --mesh 2,2 --device cpu --num-envs 8 --iters 2
    torchrun --nnodes 2 --nproc-per-node 4 ... -m gym_formation_tpu_torch.train --multihost

The arguments are the JAX package's ``train.py`` ones for its 13 algorithms,
plus ``--device`` (default ``cuda``; without a CUDA device the run stops
unless ``--device cpu`` is given).  ``--mesh DP`` trains data-parallel over DP
processes on this host, one card each (``nccl``), or on the CPU under
``--device cpu`` (``gloo``); ``--mesh DP,TP`` over DP·TP processes, each
parameter that the JAX package's rule shards cut over the TP ranks of a
data index (tensor parallelism, the ``'model'`` axis); ``--multihost``
joins the world torchrun launched, the mesh spanning it.  ``--num-envs`` is
the global batch: each data rank steps its share, and the run computes what
one process computes with the same batch and seed
(:mod:`gym_formation_tpu_torch.parallel`).  Rank 0 alone logs and writes
checkpoints, which hold the global env state and whole parameters, so they
restore under any mesh whose DP divides the batch, or none.  Every ``--log-every`` iterations one row
of metrics goes to ``<run-dir>/metrics.jsonl``; every ``--save-every``
iterations the whole training tuple goes to ``<run-dir>/ckpt/``, an
off-policy learner's replay buffer included.  The run ends with the
``mean_step_reward`` curve in ``<run-dir>/mean_step_reward.png`` and a line
``kernel launches: {...}`` with the process's launches of each kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import parallel
from gym_formation_tpu_torch.algos import ALGO_NAMES, DISCRETE_ONLY, EPISODIC, ONPOLICY, make_algo
from gym_formation_tpu_torch.ops import kernels
from gym_formation_tpu_torch.parallel import mesh as dp
from gym_formation_tpu_torch.parallel import tensor
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
    p.add_argument("--mesh", default=None, metavar="DP[,TP]",
                   help="train over DP·TP processes on this host (one card each with nccl; on the CPU with gloo "
                   "under --device cpu): data-parallel over DP, the networks' wide layers split over TP; "
                   "--num-envs must divide by DP")
    p.add_argument("--multihost", action="store_true",
                   help="join the world launched by torchrun (its environment gives the rendezvous); the mesh "
                   "spans every rank, tensor-parallel over the TP of --mesh DP,TP where given")
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
    args.run_dir = args.run_dir or os.path.join(
        "runs", f"{args.algo}_{args.scenario}_N{args.num_agents}_{int(time.time())}")
    if args.multihost:
        parallel.initialize_multihost(device_type=device.type)
        try:
            dp_size, tp_size = parse_mesh(args, None) if args.mesh else (None, 1)
            world = torch.distributed.get_world_size()
            if dp_size is not None and dp_size * tp_size != world:
                raise SystemExit(f"--mesh {args.mesh} under --multihost must span the world of {world}")
            run(parallel.pod_mesh(tp_size, device_type=device.type), args)
        finally:
            torch.distributed.destroy_process_group()
    elif args.mesh:
        dp_size, tp_size = parse_mesh(args, device.type)
        parallel.spawn(run, dp_size * tp_size, (args,), device_type=device.type, tp=tp_size)
    else:
        run(None, args)


def parse_mesh(args, device_type):
    """(DP, TP) of ``--mesh``, with ``--num-envs`` divisible by DP, or a
    stop naming the fault."""
    try:
        dp_size, tp = parallel.parse_mesh_arg(args.mesh, device_type or "cpu")
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.num_envs % dp_size:
        raise SystemExit(f"--num-envs {args.num_envs} must divide by the data-parallel mesh size {dp_size}")
    return dp_size, tp


def run(mesh, args) -> None:
    """The training loop of one process: the whole run without a mesh, a
    rank's share under one."""
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    lead = dp.rank(mesh) == 0 and tensor.rank(mesh) == 0  # logs and writes checkpoints

    kw = {}
    if args.episode_length is not None:
        kw["episode_length" if args.scenario == "formation_hd_env" else "world_length"] = args.episode_length
    env = gt.make_env(args.scenario, num_agents=args.num_agents, benchmark=args.benchmark,
                      discrete_action=args.discrete_action or args.algo in DISCRETE_ONLY, **kw)
    algo = make_algo(args.algo, env, args.num_envs, args.set, args.config, args.lr, device, mesh=mesh)
    cfg = algo.cfg

    run_dir = args.run_dir
    ckpt_dir = os.path.join(run_dir, "ckpt")
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    # (ts, env_state, obs[, carry]), (ts, buffer, env_state, obs) or (ts,
    # buffer); under a mesh the env rows are the data rank's, the networks
    # rank 0's, cut to the rank's slices on a model axis
    state = algo.init(generator)
    parallel.shard_params_(parallel.replicate_global(state[0], mesh), mesh)
    start = 0
    if args.restore:
        step = latest_step(ckpt_dir)
        if step is None:
            raise SystemExit(f"--restore: no checkpoint under {ckpt_dir} (pass the run's --run-dir)")
        state = algo.restore_tree(restore_checkpoint(ckpt_dir, step), generator)
        state = parallel.shard_train_tuple(args.algo, state, mesh) if mesh is not None else state
        start = step
        if lead:
            print(f"restored checkpoint at iteration {step} from {ckpt_dir}")

    if lead:
        print(f"{args.algo} on {args.scenario} N={args.num_agents} B={args.num_envs} device={device} "
              f"discrete={algo.discrete}: {switches(args.algo, algo)}")
        if mesh is not None and tensor.size(mesh) > 1:
            world = dp.size(mesh) * tensor.size(mesh)
            held = tensor.held_bytes(state[0])
            print(f"mesh: {{'data': {dp.size(mesh)}, 'model': {tensor.size(mesh)}}} over {world} devices")
            print(f"held a rank: params {held['params']} B, moments {held['moments']} B")
        elif mesh is not None:
            print(f"mesh: {{'data': {dp.size(mesh)}}} over {dp.size(mesh)} devices")
    if args.algo in ONPOLICY:
        steps_per_iter = cfg.rollout_len * args.num_envs
    elif args.algo in EPISODIC:
        steps_per_iter = cfg.episodes_per_iter * args.num_envs * env.world_length
    else:
        steps_per_iter = cfg.steps_per_iter * args.num_envs
    logger = MetricsLogger(run_dir) if lead else None
    dp.reset_stats(timing=mesh is not None)
    for i in range(start, start + args.iters):
        *state, m = algo.train_step(*state, generator)
        if lead and (i - start) % args.log_every == 0:
            m = {k: float(v) for k, v in m.items()}
            logger.log((i + 1) * steps_per_iter, m)
            print(f"iter {i}: {m}")
        if args.save_every and (i + 1 - start) % args.save_every == 0:
            whole = parallel.gather_train_tuple(args.algo, state, mesh)  # every rank takes part
            if lead:
                save_checkpoint(ckpt_dir, i + 1, algo.checkpoint_tree(*whole, generator), max_to_keep=2)
    if lead and mesh is not None:
        ms = dp.collective_ms()  # checkpoints' gathers included
        model = (f", model all_gather {dp.stats['model_all_gather'] / args.iters:.1f}, model all_reduce "
                 f"{dp.stats['model_all_reduce'] / args.iters:.1f}" if tensor.size(mesh) > 1 else "")
        print(f"collectives an iteration (rank 0): all_reduce {dp.stats['all_reduce'] / args.iters:.1f}, "
              f"all_gather {dp.stats['all_gather'] / args.iters:.1f}{model}, {ms / args.iters:.3f} ms")
    if lead:
        logger.plot("mean_step_reward")
        logger.close()
        # this process's launches of each kernel (0 on the CPU: plain versions)
        print(f"kernel launches: {json.dumps({k: getattr(kernels, k).launches for k in kernels.__all__})}")
        print(f"done -> {run_dir}")


if __name__ == "__main__":
    main()
