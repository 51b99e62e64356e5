"""The flagship model's forward, and a multi-process dry run of the training
programs over a data × model mesh.

    python -m gym_formation_tpu_torch.graft_entry [N] [--device cpu]

Counterpart of the JAX package's ``__graft_entry__.py``.  :func:`entry`
returns the forward of the MAPPO actor-critic at N=9 over 64 envs and its
example arguments; ``main`` runs it once and prints its output shapes
(``entry ok:``), then the dry run.  :func:`dryrun_multichip` spawns N ranks (default: every visible card; one card each with ``nccl``, or the
CPU with ``gloo`` under ``--device cpu``) each run one training iteration of
the three programs at its shapes, on the JAX package's mesh: ``(N/2, 2)``
for an even N (the env batch split over N/2 data ranks, the networks' wide
layers over 2 model ranks), ``(N, 1)`` for an odd one:

- MAPPO at N=9 agents: rollouts of 4 steps, 2 epochs of 2 minibatches;
- MADDPG at N=9: a buffer of 256, 4 env steps and 2 updates of batches of
  16 an iteration, two iterations (the second samples the filled buffer);
- MAPPO at N=243 on the structured path: rollouts of 2 steps, 1 epoch,
  ``grad_accum=2``.

Each runs at 4·DP envs and checks finite losses (and the buffer's growth).
"""

from __future__ import annotations

import argparse
import math

import torch
from torch.func import functional_call

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import _device, parallel
from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig, make_algo
from gym_formation_tpu_torch.parallel import mesh as dp
from gym_formation_tpu_torch.parallel import tensor


def entry(device="cuda"):
    """``(forward, (params, obs))``: the forward of the flagship model, the
    MAPPO actor-critic (default :class:`MAPPOConfig`) over a batch of 64
    formation_hd_env envs at N=9 (a 2-layer hierarchy of 3), on ``device``
    (the card unless ``"cpu"``).  ``params`` is ``{"actor": {name: tensor},
    "critic": {...}}`` and ``obs`` [64, 9, 54] the first observations;
    ``forward(params, obs)`` gives the actor's mean [64, 9, 2] and the
    critic's value [64] of ``obs.reshape(64, -1)``."""
    dev = _device.resolve(device)
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=9), MAPPOConfig(), num_envs=64, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ts, _, obs = algo.init(g)
    actor, critic = ts.actor, ts.critic

    def forward(params, obs):
        mean, _ = functional_call(actor, params["actor"], (obs,))
        value = functional_call(critic, params["critic"], (obs.reshape(obs.shape[0], -1),))
        return mean, value

    params = {k: {name: p.detach() for name, p in net.named_parameters()}
              for k, net in (("actor", actor), ("critic", critic))}
    return forward, (params, obs)


def _report(mesh, label: str, metrics) -> None:
    m = {k: round(float(v), 4) for k, v in metrics.items()}
    if dp.rank(mesh) == 0 and tensor.rank(mesh) == 0:
        shape = {"data": dp.size(mesh), "model": tensor.size(mesh)}
        print(f"dryrun_multichip {label} ok: mesh={shape} metrics={m}", flush=True)


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
    parallel.shard_params_(state[0], mesh)
    *state, m = algo.train_step(*state, g)
    _finite(m, "v_loss")
    _report(mesh, "mappo", m)

    env = gt.make_env("formation_hd_env", num_agents=9)
    algo = make_algo("maddpg", env, B, ["buffer_size=256", "steps_per_iter=4", "updates_per_iter=2",
                                        "batch_size=16"], device=device, mesh=mesh)
    state = algo.init(g)
    parallel.shard_params_(state[0], mesh)
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
    parallel.shard_params_(state[0], mesh)
    *state, m = algo.train_step(*state, g)
    _finite(m, "v_loss")
    _report(mesh, "mappo-n243-structured", m)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Spawn ``n_devices`` ranks on this host on the mesh ``(n/2, 2)`` (an
    even n) or ``(n, 1)`` and run :func:`dryrun_rank` on each; raises if any
    rank fails."""
    tp = 2 if n_devices >= 2 and n_devices % 2 == 0 else 1
    if device == "cuda":
        parallel.parse_mesh_arg(f"{n_devices // tp},{tp}", "cuda")
    parallel.spawn(dryrun_rank, n_devices, (device,), device_type=device, tp=tp)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=None, help="ranks (default: the visible cards)")
    p.add_argument("--device", default="cuda", help="cuda (default; nccl) or cpu (gloo)")
    args = p.parse_args(argv)
    n = args.n if args.n is not None else torch.cuda.device_count()
    if n < 1:
        raise SystemExit("no CUDA device: pass N and --device cpu to run on the CPU")
    fn, (params, obs) = entry(args.device)
    with torch.no_grad():
        out = fn(params, obs)
    print("entry ok:", tuple(tuple(t.shape) for t in out), flush=True)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
