"""The port's data parallelism (``gym_formation_tpu_torch.parallel``) on the
CPU: a run over W=2 ranks (``gloo``) computes what one process computes with
the same global batch and seed.

The unsharded port is held to the JAX package by the other
``test_torch_*`` files, so each W=2 run here is held to the port's W=1 run,
for the families of ``tests/test_sharding.py`` and its structured path:
MAPPO (autograd with two minibatches; K5 and K9's plain versions with the
env offset and the global counts; structured at N=33 with ``grad_accum``),
RMAPPO, MADDPG, MASAC, QMIX and RQMIX, each in a world of 2 beside one
process (``tests/_torch_dp_worker.py``, one launch for all of them); the
sharded fused rollout; the bench's ``--mesh`` rows; ``train --mesh`` and its checkpoint; the dry run;
the helpers; the mesh arguments' errors.

Tolerances: metrics rtol 1e-6 (``tests/test_sharding.py``'s own), on-policy
parameters rtol 1e-6 with atol 1e-9 (float64 learners: only the order of the
collectives' sums differs), off-policy parameters bit for bit (no sum
crosses ranks: every rank updates on the same gathered buffer), and every
rank's parameters bit for bit equal to rank 0's.  K5 and K9 compute in
float32 whatever the learner's dtype, as the kernels do, so the fused
family's and the float32 CLI's PPO metrics (differences of nearly equal
float32 sums) take an atol of 1e-7 and 1e-6 beside the rtol.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from gym_formation_tpu_torch import parallel
from gym_formation_tpu_torch.algos.mappo import MAPPOConfig
from gym_formation_tpu_torch.models.networks import GaussianActor, ValueCritic
from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9
from gym_formation_tpu_torch.ops.kernels.fused_rollout import state_to_soa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("mappo", "mappo_fused", "mappo_structured", "rmappo", "maddpg", "masac", "qmix", "rqmix")
ONPOLICY = ("mappo", "mappo_fused", "mappo_structured", "rmappo")
HELPERS = ("local_rows", "scalar_whole", "gathered", "replicated", "unequal_scalar_refused")


def run(args, timeout, **kw):
    """A subprocess in its own session (its ranks included), killed whole
    if it outlives ``timeout``.  Returns the CompletedProcess."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    p = subprocess.Popen([sys.executable, *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, start_new_session=True, **kw)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """W=1 and the two ranks of W=2, from tests/_torch_dp_worker.py."""
    out = tmp_path_factory.mktemp("dp")
    r = run(["tests/_torch_dp_worker.py", str(out)], timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    load = lambda f: torch.load(out / f, weights_only=False)
    return load("w1.pt"), load("w2_rank0.pt"), load("w2_rank1.pt")


# -- the mesh arguments ---------------------------------------------------------

@pytest.mark.parametrize("spec", ["0", "1,2,3", "2,0", "x"])
def test_parse_mesh_arg_refuses_malformed(spec):
    with pytest.raises(ValueError, match="DP or DP,TP"):
        parallel.parse_mesh_arg(spec, "cpu")


def test_parse_mesh_arg_accepts_tensor_parallel():
    assert parallel.parse_mesh_arg("4,2", "cpu") == (4, 2)
    with pytest.raises(ValueError, match="needs 8 devices"):
        parallel.parse_mesh_arg("4,2", "cuda", devices=4)


def test_parse_mesh_arg_refuses_more_ranks_than_cards():
    assert parallel.parse_mesh_arg("2", "cpu") == (2, 1)
    assert parallel.parse_mesh_arg("2,1", "cuda", devices=2) == (2, 1)
    with pytest.raises(ValueError, match="needs 4 devices, only 2"):
        parallel.parse_mesh_arg("4", "cuda", devices=2)


def test_placements_are_torchs():
    from torch.distributed.tensor import Replicate, Shard

    assert parallel.batch_sharding() == Shard(0) and parallel.replicated() == Replicate()


def test_per_host_batch_and_indivisible_num_envs():
    assert parallel.per_host_batch(8) == 8  # one process
    with pytest.raises(ValueError, match="must divide by the data-parallel mesh size 2"):
        parallel.mesh.per_rank(7, _Mesh2())
    from gym_formation_tpu_torch import train

    with pytest.raises(SystemExit, match="--num-envs 7 must divide by the data-parallel mesh size 2"):
        train.main(["--device", "cpu", "--mesh", "2", "--num-envs", "7", "--iters", "1"])


class _Mesh2:
    """The two methods of a DeviceMesh of 2 ranks that the size checks read."""

    mesh_dim_names = ("data",)

    def size(self, dim=0):
        return 2


# -- a world of 2 against one process ----------------------------------------------

@pytest.mark.parametrize("key", HELPERS)
def test_helpers_round_trip_in_a_world_of_two(worlds, key):
    _, r0, r1 = worlds
    assert r0["helpers"][key] and r1["helpers"][key]


@pytest.mark.parametrize("family", FAMILIES)
def test_w2_metrics_equal_w1(worlds, family):
    w1, w2, _ = worlds
    atol = 1e-7 if family == "mappo_fused" else 0.0
    assert len(w1[family]["metrics"]) == len(w2[family]["metrics"])
    for m1, m2 in zip(w1[family]["metrics"], w2[family]["metrics"]):
        assert m1.keys() == m2.keys()
        for k in m1:
            np.testing.assert_allclose(m2[k], m1[k], rtol=1e-6, atol=atol, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_w2_params_equal_w1(worlds, family):
    w1, w2, _ = worlds
    for a, b in zip(w1[family]["params"], w2[family]["params"], strict=True):
        if family in ONPOLICY:
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)
        else:
            assert torch.equal(b, a)


@pytest.mark.parametrize("family", FAMILIES)
def test_every_rank_holds_rank0_params(worlds, family):
    _, r0, r1 = worlds
    for a, b in zip(r0[family]["params"], r1[family]["params"], strict=True):
        assert torch.equal(a, b)


def test_sharded_fused_rollout_equals_unsharded_bit_for_bit(worlds):
    """N=27, B=16, T=8, episodes of 5 (a reset crossed), the in-kernel BFS
    policy: K3's and the masked K2's plain versions on each rank's rows, the
    reset drawn globally and sliced."""
    (s1, r1), (s2, r2) = worlds[0]["fused_rollout"], worlds[1]["fused_rollout"]
    assert r1.shape == r2.shape == (8, 16)
    assert torch.equal(r2, r1)
    for f in ("pos", "vel", "ideal_shape", "ideal_vel", "t"):
        assert torch.equal(getattr(s2, f), getattr(s1, f)), f
    assert bool((s1.t == 8 - 5).all())  # every env reset at step 5


@pytest.mark.parametrize("kernel", ["None", "bfs_ez"])
def test_bench_mesh_chunk_equals_unsharded_bit_for_bit(worlds, kernel):
    """The bench's bfs_state chunk (the step path, and the fused route with
    K3's and the masked K2's plain versions) on each rank's rows, a reset
    crossed: every env's reward sum equals one process's."""
    w1, r0, r1 = (w["bench"][f"chunk_{kernel}"] for w in worlds)
    assert w1.shape == (8,)
    assert torch.equal(r0, w1) and torch.equal(r1, w1)


@pytest.mark.parametrize("policy", ["bfs_state", "ezpolicy", "random"])
def test_bench_mesh_run_equals_unsharded(worlds, policy):
    """``bench.run`` under ``--mesh 2 --device cpu``: the global reward sum
    each window fetched (an all_reduce of the ranks' sums) is one process's
    up to the order of the float32 sums (rtol 1e-6), and the same on both
    ranks."""
    w1, r0, r1 = (w["bench"][f"run_{policy}"] for w in worlds)
    assert len(w1) == 2 and r0 == r1
    np.testing.assert_allclose(r0, w1, rtol=1e-6)


# -- the kernels' data-parallel arguments (plain versions) --------------------------

def _k5_inputs(B, seed=0):
    import gym_formation_tpu_torch as gt

    g = torch.Generator()
    g.manual_seed(seed)
    env = gt.make_env("formation_hd_env", num_agents=3)
    soa = state_to_soa(env.reset_state(g, B))
    soa = soa._replace(t=torch.randint(0, 6, (1, B), generator=g, dtype=torch.int32))
    tg = torch.Generator()
    tg.manual_seed(seed + 1)
    actor, critic = GaussianActor(18, 2, (64, 64), generator=tg), ValueCritic(54, (64, 64), generator=tg)
    return soa, k5.actor_planes(actor), k5.critic_planes(critic)


@pytest.mark.parametrize("offset,rows", [(0, 5), (3, 5), (8, 8)])
def test_k5_env_offset_draws_the_whole_batchs_rows(offset, rows):
    """At ``env_offset`` o over b envs, K5's plain version gives rows
    [o, o + b) of one launch over o + b envs, bit for bit: every draw is
    keyed by the env's global index (6-step episodes, so resets draw)."""
    soa, aops, cops = _k5_inputs(offset + rows)
    kw = dict(length=8, ep_len=6, n=3)
    whole_s, whole = k5.fused_collect_hd_plain(soa, aops, cops, 123, **kw)
    part = soa._replace(**{f: getattr(soa, f)[:, offset:] for f in soa._fields})
    s, tr = k5.fused_collect_hd_plain(part, aops, cops, 123, env_offset=offset, **kw)
    for f in soa._fields:
        assert torch.equal(getattr(s, f), getattr(whole_s, f)[:, offset:]), f
    for k in tr:
        assert torch.equal(tr[k], whole[k][:, offset:]), k
    assert bool(whole["done"].any())
    if offset:  # without the offset the part's draws are env 0's
        _, wrong = k5.fused_collect_hd_plain(part, aops, cops, 123, **kw)
        assert not torch.equal(wrong["action"], whole["action"][:, offset:])


def _k9_batch(M, seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)
    data = {"obs": r(M, 3, 18), "action": r(M, 3, 2), "logp": r(M, 3) - 2.0, "adv": r(M),
            "value": r(M), "target": r(M)}
    tg = torch.Generator()
    tg.manual_seed(seed + 1)
    actor, critic = GaussianActor(18, 2, (64, 64), generator=tg), ValueCritic(54, (64, 64), generator=tg)
    f = lambda t: t.detach().contiguous()
    (a1, a2), (c1, c2) = actor.mlp.layers, critic.mlp.layers
    aops = (f(a1.weight.T), f(a1.bias), f(a2.weight.T), f(a2.bias), f(actor.head.weight.T),
            f(actor.head.bias), f(actor.bounded_log_std()))
    cops = (f(c1.weight.T), f(c1.bias), f(c2.weight.T), f(c2.bias), f(critic.head.weight.T), f(critic.head.bias))
    return data, aops, cops


K9_KW = dict(n_agents=3, act_dim=2, clip_eps=0.2, huber_delta=10.0, value_coef=1.0)


def test_k9_global_counts_scale_exactly():
    """``global_rows`` = M is the default, bit for bit."""
    data, aops, cops = _k9_batch(40)
    a = k9.fused_ppo_grads_plain(data, aops, cops, **K9_KW)
    b = k9.fused_ppo_grads_plain(data, aops, cops, global_rows=40, **K9_KW)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


def test_k9_halves_with_global_counts_sum_to_the_whole():
    """Two halves of a batch, each scaled by the whole batch's counts, sum
    to the whole batch's gradient: to float32's rounding of the two partial
    row sums (the plain version computes in float32, as K9 does)."""
    M = 40
    data, aops, cops = _k9_batch(M)
    whole_a, whole_c, whole_m = k9.fused_ppo_grads_plain(data, aops, cops, **K9_KW)
    halves = [k9.fused_ppo_grads_plain({k: v[s] for k, v in data.items()}, aops, cops, global_rows=M, **K9_KW)
              for s in (slice(0, 24), slice(24, M))]
    for i, whole in enumerate(whole_a + whole_c):
        parts = [h[0][i] if i < len(whole_a) else h[1][i - len(whole_a)] for h in halves]
        torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(halves[0][2] + halves[1][2], whole_m, rtol=1e-5, atol=1e-6)


# -- the entry points ------------------------------------------------------------

CLI = {
    "mappo": ["--set", "rollout_len=4", "--set", "ppo_epochs=2", "--set", "num_minibatches=2"],
    "maddpg": ["--set", "buffer_size=256", "--set", "steps_per_iter=4", "--set", "updates_per_iter=2",
               "--set", "batch_size=16"],
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``train --mesh 1`` and ``--mesh 2`` on the CPU for mappo and maddpg
    (8 envs, 2 iterations, a checkpoint at the end); then, without
    ``--mesh``, a restore of the W=2 checkpoint for one more iteration and
    ``eval`` of it."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for algo, extra in CLI.items():
        for mesh in ("1", "2"):
            d = root / f"{algo}_{mesh}"
            r = run(["-m", "gym_formation_tpu_torch.train", "--algo", algo, "--device", "cpu", "--mesh", mesh,
                     "--num-envs", "8", "--iters", "2", "--log-every", "1", "--save-every", "2",
                     "--run-dir", str(d), *extra], timeout=240)
            out[algo, mesh] = (r, d)
        d = root / f"{algo}_2"
        out[algo, "restore"] = run(["-m", "gym_formation_tpu_torch.train", "--algo", algo, "--device", "cpu",
                                    "--num-envs", "8", "--iters", "1", "--save-every", "0", "--restore",
                                    "--run-dir", str(d), *extra], timeout=240)
        out[algo, "eval"] = run(["-m", "gym_formation_tpu_torch.eval", "--policy", "ckpt", "--algo", algo,
                                 "--ckpt", str(d / "ckpt"), "--episodes", "1", "--device", "cpu"], timeout=240)
    return out


@pytest.mark.parametrize("algo", sorted(CLI))
def test_train_mesh_cli_equals_mesh_1(cli_runs, algo):
    rows = {}
    for mesh in ("1", "2"):
        r, d = cli_runs[algo, mesh]
        assert r.returncode == 0, r.stderr[-3000:]
        assert f"mesh: {{'data': {mesh}}} over {mesh} devices" in r.stdout
        rows[mesh] = [json.loads(line) for line in open(d / "metrics.jsonl")]
        assert (d / "ckpt" / "2.pt").exists()
    assert len(rows["1"]) == 2
    # the CLI trains in float32: the PPO losses are differences of nearly
    # equal float32 sums, hence the atol
    atol = 1e-6 if algo == "mappo" else 0.0
    for a, b in zip(rows["1"], rows["2"][:2], strict=True):  # [2]: the restored run's
        assert a.keys() == b.keys()
        for k in a:
            if k != "wall":
                np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=atol, err_msg=k)


@pytest.mark.parametrize("algo", sorted(CLI))
def test_mesh_checkpoint_restores_unsharded_and_evaluates(cli_runs, algo):
    r, d = cli_runs[algo, "2"]
    tree = torch.load(d / "ckpt" / "2.pt", weights_only=False)
    assert tree["env_state"]["pos"].shape[0] == 8  # the global env state, gathered
    assert tree["obs"].shape[0] == 8
    r = cli_runs[algo, "restore"]
    assert r.returncode == 0, r.stderr[-3000:]
    assert "restored checkpoint at iteration 2" in r.stdout and "mesh:" not in r.stdout
    r = cli_runs[algo, "eval"]
    assert r.returncode == 0, r.stderr[-3000:]
    assert "return" in r.stdout.lower()


def test_dryrun_multichip_two_ranks_on_the_cpu():
    r = run(["-m", "gym_formation_tpu_torch.graft_entry", "2", "--device", "cpu"], timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("entry ok: ((64, 9, 2), (64,))\n")  # entry()'s forward, before the dry run
    for label in ("mappo", "maddpg", "mappo-n243-structured"):
        assert f"dryrun_multichip {label} ok: mesh={{'data': 1, 'model': 2}}" in r.stdout


def test_a_failing_rank_fails_the_run():
    """No fallback: a rank that raises makes the whole world fail."""
    r = run(["tests/_torch_dp_worker.py", "--fail-rank-1"], timeout=120)
    assert r.returncode != 0
    assert "RuntimeError: rank 1 fails" in r.stderr


def test_new_modules_import_no_jax():
    r = run(["-c", "import sys\n"
                   "import gym_formation_tpu_torch.parallel, gym_formation_tpu_torch.graft_entry\n"
                   "import gym_formation_tpu_torch.train\n"
                   "assert not any(m == 'jax' or m.startswith(('jax.', 'gym_formation_tpu.')) "
                   "or m == 'gym_formation_tpu' for m in sys.modules), sorted(sys.modules)\n"], timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


def test_mappo_counts_its_rows_per_rank():
    """The learner's batch under a mesh is the rank's share of the global
    one (a stand-in mesh of 2)."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import MAPPO

    env = gt.make_env("formation_hd_env", num_agents=3, mesh=_Mesh2())
    algo = MAPPO(env, MAPPOConfig(), num_envs=8, device="cpu")
    assert (algo.global_envs, algo.num_envs) == (8, 4)
    with pytest.raises(ValueError, match="must divide"):
        MAPPO(env, MAPPOConfig(), num_envs=7, device="cpu")
