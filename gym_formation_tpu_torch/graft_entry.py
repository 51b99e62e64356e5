"""A multi-process dry run of the training programs over a data-parallel mesh.

    python -m gym_formation_tpu_torch.graft_entry [N] [--device cpu]

Counterpart of the JAX package's ``__graft_entry__.py: dryrun_multichip``:
N ranks (default: every visible card; one card each with ``nccl``, or the
CPU with ``gloo`` under ``--device cpu``) each run one training iteration of
the three programs at its shapes, with the env batch split over the ranks
(``dp = N``; the tensor-parallel half of the JAX mesh is not ported yet):

- MAPPO at N=9 agents: rollouts of 4 steps, 2 epochs of 2 minibatches;
- MADDPG at N=9: a buffer of 256, 4 env steps and 2 updates of batches of
  16 an iteration, two iterations (the second samples the filled buffer);
- MAPPO at N=243 on the structured path: rollouts of 2 steps, 1 epoch,
  ``grad_accum=2``.

Each runs at 4·N envs and checks finite losses (and the buffer's growth).
"""

from __future__ import annotations

import argparse
import math

import torch

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import parallel
from gym_formation_tpu_torch.algos import make_algo
from gym_formation_tpu_torch.parallel import mesh as dp


def _report(mesh, label: str, metrics) -> None:
    m = {k: round(float(v), 4) for k, v in metrics.items()}
    if dp.rank(mesh) == 0:
        print(f"dryrun_multichip {label} ok: mesh={{'data': {dp.size(mesh)}}} metrics={m}", flush=True)


def _finite(metrics, key: str) -> None:
    if not math.isfinite(float(metrics[key])):
        raise RuntimeError(f"non-finite {key}: {metrics}")


def dryrun_rank(mesh, device: str = "cuda") -> None:
    """The three programs on this rank of ``mesh``."""
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    B = 4 * dp.size(mesh)
    g = torch.Generator(device=device)
    g.manual_seed(0)

    env = gt.make_env("formation_hd_env", num_agents=9)
    algo = make_algo("mappo", env, B, ["rollout_len=4", "ppo_epochs=2", "num_minibatches=2"], device=device,
                     mesh=mesh)
    state = algo.init(g)
    *state, m = algo.train_step(*state, g)
    _finite(m, "v_loss")
    _report(mesh, "mappo", m)

    env = gt.make_env("formation_hd_env", num_agents=9)
    algo = make_algo("maddpg", env, B, ["buffer_size=256", "steps_per_iter=4", "updates_per_iter=2",
                                        "batch_size=16"], device=device, mesh=mesh)
    state = algo.init(g)
    for _ in range(2):  # the second iteration samples the now-filled buffer
        *state, m = algo.train_step(*state, g)
    _finite(m, "critic_loss")
    if state[1].size <= 0:
        raise RuntimeError("the replay buffer did not advance")
    _report(mesh, "maddpg", m)

    env = gt.make_env("formation_hd_env", num_agents=243)
    algo = make_algo("mappo", env, B, ["rollout_len=2", "ppo_epochs=1", "grad_accum=2"], device=device,
                     mesh=mesh)
    if not algo.structured_obs:
        raise RuntimeError("N=243 MAPPO should take the structured path")
    state = algo.init(g)
    *state, m = algo.train_step(*state, g)
    _finite(m, "v_loss")
    _report(mesh, "mappo-n243-structured", m)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Spawn ``n_devices`` ranks on this host and run :func:`dryrun_rank`
    on each; raises if any rank fails."""
    if device == "cuda":
        parallel.parse_mesh_arg(str(n_devices), "cuda")
    parallel.spawn(dryrun_rank, n_devices, (device,), device_type=device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=None, help="ranks (default: the visible cards)")
    p.add_argument("--device", default="cuda", help="cuda (default; nccl) or cpu (gloo)")
    args = p.parse_args(argv)
    n = args.n if args.n is not None else torch.cuda.device_count()
    if n < 1:
        raise SystemExit("no CUDA device: pass N and --device cpu to run on the CPU")
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
