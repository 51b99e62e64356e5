"""The runs that ``tests/test_torch_parallel.py`` compares: each learner
family and the sharded fused rollout, once in this process without a mesh
(W=1) and once in a world of 2 ranks on the CPU (``gloo``, W=2), from the
same seeds; the bench's rows; plus the parallel helpers' round trips
inside the world.

    python tests/_torch_dp_worker.py OUT_DIR
    python tests/_torch_dp_worker.py --fail-rank-1   # rank 1 raises: the world fails

writes ``OUT_DIR/w1.pt`` and ``OUT_DIR/w2_rank{0,1}.pt``: for each family
the metrics of every iteration and the parameters at the end (rank 0 also
the gathered rollout).  Imports no JAX.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gym_formation_tpu_torch as gt  # noqa: E402
from gym_formation_tpu_torch import parallel  # noqa: E402
from gym_formation_tpu_torch.algos import make_algo  # noqa: E402
from gym_formation_tpu_torch.algos.mappo import MAPPO, MAPPOConfig  # noqa: E402
from gym_formation_tpu_torch.algos.rmappo import RMAPPO, RMAPPOConfig  # noqa: E402
from gym_formation_tpu_torch.parallel import mesh as dp  # noqa: E402

B = 8  # global envs of every learner
ITERS = 2
F64 = torch.float64
OFFPOLICY_SETS = ["buffer_size=256", "batch_size=16", "steps_per_iter=4", "updates_per_iter=2"]
EPISODIC_SETS = ["buffer_episodes=64", "batch_episodes=8", "episodes_per_iter=1", "updates_per_iter=2"]


def onpolicy(cls, cfg, n, mesh, **env_kw):
    env = gt.make_env("formation_hd_env", num_agents=n, dtype=F64, mesh=mesh, **env_kw)
    return cls(env, cfg, num_envs=B, device="cpu", dtype=F64)


def offpolicy(name, sets, mesh, **env_kw):
    env = gt.make_env("formation_hd_env", num_agents=3, discrete_action=name in ("qmix", "rqmix"), **env_kw)
    return make_algo(name, env, B, sets, device="cpu", mesh=mesh)


FAMILIES = {
    "mappo": lambda m: onpolicy(MAPPO, MAPPOConfig(rollout_len=4, ppo_epochs=2, num_minibatches=2), 3, m),
    "mappo_fused": lambda m: onpolicy(MAPPO, MAPPOConfig(rollout_len=4, ppo_epochs=2, fused_collect=True,
                                                         fused_update=True), 3, m),
    "mappo_structured": lambda m: onpolicy(MAPPO, MAPPOConfig(rollout_len=2, ppo_epochs=2, num_minibatches=2,
                                                              grad_accum=2), 33, m),
    "rmappo": lambda m: onpolicy(RMAPPO, RMAPPOConfig(rollout_len=4, ppo_epochs=2, num_minibatches=2,
                                                      data_chunk_length=2), 3, m, episode_length=3),
    "maddpg": lambda m: offpolicy("maddpg", OFFPOLICY_SETS, m),
    "masac": lambda m: offpolicy("masac", OFFPOLICY_SETS + ["warmup_random_steps=8"], m),
    "qmix": lambda m: offpolicy("qmix", OFFPOLICY_SETS, m),
    "rqmix": lambda m: offpolicy("rqmix", EPISODIC_SETS, m, episode_length=4),
}


def params_of(ts):
    if hasattr(ts, "params"):
        return [p.detach().clone() for p in ts.params()]
    nets = [getattr(ts, f) for f in ("actor", "critic", "q", "mixer") if getattr(ts, f, None) is not None]
    return [p.detach().clone() for net in nets for p in net.parameters()]


def train(name, mesh):
    algo = FAMILIES[name](mesh)
    g = torch.Generator()
    g.manual_seed(11)
    state = algo.init(g)
    metrics = []
    for _ in range(ITERS if name.startswith(("mappo", "rmappo")) else 3):
        *state, m = algo.train_step(*state, g)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": params_of(state[0])}


def fused_rollout(mesh):
    """The fixture of the JAX package's sharded fused-rollout test: N=27,
    B=16, T=8, episodes of 5 steps (a reset is crossed), the in-kernel BFS
    policy; the global results."""
    env = gt.FormationEnv(gt.make_scenario("formation_hd_env", num_agents=27, episode_length=5))
    g = torch.Generator()
    g.manual_seed(5)
    state = env.reset_state(g, 16)  # the global batch, on every rank
    if mesh is None:
        return gt.rollout_statepolicy_fused(env, None, state, g, 8, policy="bfs_ez")
    st, rew = gt.rollout_statepolicy_fused_sharded(env, None, parallel.shard_batch(state, mesh), g, 8, mesh,
                                                   policy="bfs_ez")
    return parallel.host_local_to_global(st, mesh), parallel.host_local_to_global(rew.T, mesh).T


def bench_rows(mesh):
    """The bench (``gym_formation_tpu_torch.bench``) at tiny shapes on the
    CPU: its bfs_state chunk on the step path and on the fused route
    (N=9, B=8, 5 steps, episodes of 3: a reset crossed), each env's reward
    sum gathered; and ``bench.run`` of the bfs_state (fused), ezpolicy and
    random rows as ``--mesh 2 --device cpu`` runs them on each rank, the
    global reward sums its windows fetched."""
    from gym_formation_tpu_torch import bench

    out = {}
    for kernel in (None, "bfs_ez"):
        env = gt.make_env("formation_hd_env", num_agents=9, episode_length=3, mesh=mesh)
        g = torch.Generator()
        g.manual_seed(2)
        whole = gt.make_env("formation_hd_env", num_agents=9, episode_length=3).reset_state(g, B)
        pol = bench.make_policy("bfs_state", env, "cpu", mesh)
        _, rs = bench.statepolicy_chunk(env, parallel.shard_batch(whole, mesh), g, 5, pol, kernel, mesh)
        if kernel is not None:  # each env's steps summed along a contiguous row, as on one process
            rs = rs.T.contiguous().sum(-1)
        out[f"chunk_{kernel}"] = parallel.host_local_to_global(rs, mesh)
    for policy, n in (("bfs_state", 9), ("ezpolicy", 3), ("random", 3)):
        argv = ["--device", "cpu", "--policy", policy, "--num-agents", str(n), "--num-envs", str(B), "--chunk", "4",
                "--iters", "2", "--windows", "2", "--step-kernel", "fused"]
        if mesh is not None:
            argv += ["--mesh", str(dp.size(mesh))]
        out[f"run_{policy}"] = bench.run(mesh, bench.build_parser().parse_args(argv))["sums"]
    return out


def helpers(mesh):
    """The round trips of shard_batch, host_local_to_global and
    replicate_global in the world."""
    r = dp.rank(mesh)
    x = torch.arange(24.0, dtype=F64).reshape(8, 3)
    local = parallel.shard_batch({"x": x, "s": torch.tensor(2.0)}, mesh)
    back = parallel.host_local_to_global(local, mesh)
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        net.weight.fill_(float(r))
    t = torch.full((4,), float(r + 1))
    parallel.replicate_global({"net": net, "t": t}, mesh)
    try:
        parallel.host_local_to_global(torch.tensor(float(r)), mesh)
        scalar_refused = False
    except ValueError:
        scalar_refused = True
    return {
        "local_rows": torch.equal(local["x"], x[4 * r:4 * r + 4]),
        "scalar_whole": bool(local["s"] == 2.0),
        "gathered": torch.equal(back["x"], x) and bool(back["s"] == 2.0),
        "replicated": bool((net.weight == 0).all()) and torch.equal(t, torch.ones(4)),
        "unequal_scalar_refused": scalar_refused,
    }


def run_all(mesh):
    out = {name: train(name, mesh) for name in FAMILIES}
    out["fused_rollout"] = fused_rollout(mesh)
    out["bench"] = bench_rows(mesh)
    if mesh is not None:
        out["helpers"] = helpers(mesh)
    return out


def rank_main(mesh, out_dir):
    torch.save(run_all(mesh), os.path.join(out_dir, f"w2_rank{dp.rank(mesh)}.pt"))


def fail_rank_1(mesh):
    if dp.rank(mesh) == 1:
        raise RuntimeError("rank 1 fails")


if __name__ == "__main__":
    if sys.argv[1] == "--fail-rank-1":
        parallel.spawn(fail_rank_1, 2, device_type="cpu")
        sys.exit(0)
    out_dir = sys.argv[1]
    torch.save(run_all(None), os.path.join(out_dir, "w1.pt"))
    parallel.spawn(rank_main, 2, (out_dir,), device_type="cpu")
