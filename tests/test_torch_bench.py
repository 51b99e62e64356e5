"""The port's bench (``gym_formation_tpu_torch.bench``) and the flagship
forward (``graft_entry.entry``) on the CPU, held against the JAX package:

- the SUITE and the parser's defaults, against the root ``bench.py``'s
  source (read, not imported: importing it starts JAX's compile cache);
- each SUITE row's chunk against the composition the root ``bench.py: run``
  builds on the same injected state: row 1 (K4's plain version) against the
  JAX ``fused_rollout_hd(interpret=True)`` across a reset (its counter PRNG
  is reproduced bit for bit); row 2 on the fused route (K3 with the
  in-kernel BFS and the masked K2, plain versions) against
  ``rollout_statepolicy_fused(policy="bfs_ez")`` and on the step path
  against ``rollout_statepolicy_rewardsum``, within the first episode; row 3
  and the other observation policies against ``rollout`` summed, in
  float64, within the first episode (the two packages draw their resets
  from different generators);
- the routes each row takes on a card, the CLI's lines and refusals;
- ``entry()`` against the JAX ``entry()`` on converted parameters.

The ``--mesh`` run is held to one process in ``tests/test_torch_parallel.py``
(inside its one gloo world).
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.core.types import EnvState as JEnvState
from gym_formation_tpu.ops.pallas import fused_rollout as jfr

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import bench
from gym_formation_tpu_torch.models.networks import actor_from_flax, critic_from_flax
from gym_formation_tpu_torch.ops.kernels import fused_rollout as tfr
from gym_formation_tpu_torch.ops.kernels import fused_step, pairforce_sym, reward_sym

from test_torch_physics import fake_card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
EMIT_KEYS = ["metric", "value", "unit", "vs_baseline", "windows", "min", "max"]


def _root_suite():
    """The SUITE of the root bench.py, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "SUITE" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("bench.py has no SUITE")


def _args(argv):
    return bench.build_parser().parse_args(argv)


# -- the SUITE, the parser, the line ------------------------------------------------

def test_suite_covers_baseline_configs():
    """tests/test_misc.py: test_bench_suite_covers_baseline_configs, for the
    port, and the rows equal to the root bench.py's, in its order."""
    suite = bench.SUITE
    assert suite == _root_suite()
    assert suite[0] == {}  # headline first: formation_hd_env N=3 defaults
    assert suite[1] == {"num_agents": 243, "policy": "bfs_state"}
    assert suite[2] == {"scenario": "basic_formation_env"}
    a = _args([])
    assert a.scenario == "formation_hd_env" and a.num_agents == 3
    assert a.num_envs == 4096 and a.windows == 3
    assert (a.chunk, a.iters, a.policy, a.fused, a.step_kernel, a.mesh, a.device) == (
        256, 16, "ezpolicy", "auto", "auto", None, "cuda")
    assert bench.BASELINE_STEPS_PER_SEC == 1_000_000.0


def test_rows_with_and_without_arguments():
    """No arguments: the SUITE's three rows in order; any argument: one."""
    rows = bench.rows(_args([]), [])
    assert [(r.scenario, r.num_agents, r.policy) for r in rows] == [
        ("formation_hd_env", 3, "ezpolicy"), ("formation_hd_env", 243, "bfs_state"),
        ("basic_formation_env", 3, "ezpolicy")]
    one = bench.rows(_args(["--num-envs", "8"]), ["--num-envs", "8"])
    assert len(one) == 1 and one[0].num_envs == 8


def test_emit_keys(capsys):
    bench.emit("m", [3.0, 1.0, 2.0])
    line = json.loads(capsys.readouterr().out)
    assert list(line) == EMIT_KEYS
    assert (line["value"], line["min"], line["max"], line["windows"]) == (2.0, 1.0, 3.0, 3)
    assert line["vs_baseline"] == 0.0 and line["unit"] == "env-steps/s"


def test_metric_strings_are_the_root_benchs():
    """The strings bench.py composes (its :206-208 and :380-382)."""
    k4 = _args([])
    assert bench.metric_of(k4, True) == (
        "env-steps/s/chip (formation_hd_env, N=3, 4096 envs, ezpolicy policy, fused rollout kernel)")
    row2 = _args(["--num-agents", "243", "--policy", "bfs_state"])
    assert bench.metric_of(row2, False) == "env-steps/s/chip (formation_hd_env, N=243, 4096 envs, bfs_state policy)"
    row3 = _args(["--scenario", "basic_formation_env"])
    assert bench.metric_of(row3, False) == (
        "env-steps/s/chip (basic_formation_env, N=3, 4096 envs, ezpolicy policy)")


def test_routes_on_a_card(capsys):
    """The JAX package's gates with 'tpu' read as 'cuda': K4 for the
    headline on a card only; K3 for bfs_state on a card, the in-kernel BFS
    at arity 3, the external expansion (with a note) otherwise."""
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert bench.uses_k4(_args([]), card)
    assert not bench.uses_k4(_args([]), cpu)
    assert bench.uses_k4(_args(["--fused", "on"]), cpu)
    for argv in (["--num-envs", "1000"], ["--mesh", "2"], ["--policy", "bfs"], ["--fused", "off"]):
        assert not bench.uses_k4(_args(argv), card), argv
    assert bench.uses_k4(_args(["--fused", "on", "--mesh", "2"]), card)
    assert not bench.uses_k4(_args(["--fused", "on", "--scenario", "basic_formation_env"]), card)
    row2 = ["--num-agents", "243", "--policy", "bfs_state"]
    assert bench.step_kernel_policy(_args(row2), card) == "bfs_ez"
    assert bench.step_kernel_policy(_args(row2), cpu) is None
    assert bench.step_kernel_policy(_args(row2 + ["--step-kernel", "plain"]), card) is None
    assert bench.step_kernel_policy(_args(row2 + ["--step-kernel", "fused"]), cpu) == "bfs_ez"
    capsys.readouterr()
    assert bench.step_kernel_policy(_args(["--num-agents", "16", "--policy", "bfs_state"]), card) == "external"
    assert "n=2): in-kernel BFS unavailable" in capsys.readouterr().err
    assert [bench.bfs_arity(n) for n in (3, 9, 16, 243, 5, 6)] == [3, 3, 2, 3, 5, 6]


def test_k4_outside_its_agent_counts_raises_on_a_card(monkeypatch):
    """--fused on at n=5: on a (simulated) card K4 refuses before any
    launch; it does not drop to the plain version."""
    calls = fake_card(monkeypatch)
    env = gt.make_env("formation_hd_env", num_agents=5)
    soa = tfr.state_to_soa(env.reset_state(torch.Generator(), 4))
    with pytest.raises(ValueError, match="K4 is built for n"):
        bench.k4_chunk(env, soa, 1, 2)
    assert calls == [] and tfr.launches == 0


def test_no_card_stops_the_bench(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(None, _args(["--num-envs", "8"]))


CLI_ROWS = {
    "k4": (["--fused", "on", "--num-envs", "16"], "fused rollout kernel"),
    "bfs_state_fused": (["--num-agents", "27", "--policy", "bfs_state", "--step-kernel", "fused"], "bfs_state policy"),
    "bfs_state_plain": (["--num-agents", "9", "--policy", "bfs_state"], "bfs_state policy"),
    "basic": (["--scenario", "basic_formation_env"], "ezpolicy policy"),
    "bfs": (["--num-agents", "9", "--policy", "bfs"], "bfs policy"),
    "random": (["--policy", "random"], "random policy"),
    "linear": (["--scenario", "formation_hd_partial_env", "--num-agents", "4", "--policy", "linear"],
               "linear policy"),
}


@pytest.mark.parametrize("row", sorted(CLI_ROWS))
def test_row_prints_one_line(row, capsys):
    """Each path through main on the CPU at tiny shapes: one JSON line with
    emit's keys, the metric of its row, finite rates > 0."""
    argv, tail = CLI_ROWS[row]
    argv = argv + ["--device", "cpu", "--chunk", "3", "--iters", "2", "--windows", "2"]
    if "--num-envs" not in argv:
        argv += ["--num-envs", "4"]
    bench.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == EMIT_KEYS and line["metric"].endswith(f"{tail})")
    assert line["windows"] == 2 and np.isfinite(line["value"]) and 0 < line["min"] <= line["max"]


def test_k4_row_runs_64_chunks_a_window(monkeypatch):
    """bench.py's K4 row closes its window after max(iters, 64) chunks: one
    warm-up chunk, then 64 a window at --iters 2 (the chunks counted where
    run calls them)."""
    seeds, k4_chunk = [], bench.k4_chunk

    def counted(env, soa, seed, *rest):
        seeds.append(seed)
        return k4_chunk(env, soa, seed, *rest)

    monkeypatch.setattr(bench, "k4_chunk", counted)
    res = bench.run(None, _args(["--fused", "on", "--num-envs", "8", "--chunk", "1", "--iters", "2", "--windows", "2",
                                 "--device", "cpu"]))
    assert seeds == list(range(1, 2 + 2 * 64))
    assert len(res["rates"]) == 2 and all(np.isfinite(res["sums"]))


# -- row 1: K4 ---------------------------------------------------------------------------

def test_row1_k4_chunk_matches_jax_across_a_reset():
    """n=3, B=512 (bench.py's block), episode counters 0..99 so that a
    quarter of the envs reset within the 25 steps, the seed of the first
    timed chunk.  Tolerances of tests/test_torch_fused_rollout.py: state
    1e-5, reward sums rtol 5e-6, atol 2e-3, counters exact."""
    n, B, T = 3, 512, 25
    env = gt.make_env("formation_hd_env", num_agents=n)
    rng = np.random.RandomState(0)
    ap, ish = rng.uniform(-1, 1, (2 * n, B)), rng.uniform(-1, 1, (2 * n, B))
    ish[:n] -= ish[:n].mean(0)
    ish[n:] -= ish[n:].mean(0)
    planes = [a.astype(np.float32) for a in (ap, rng.uniform(-0.2, 0.2, (2 * n, B)), ish,
                                             rng.uniform(-1, 1, (2, B)))]
    planes.append((np.arange(B) % env.world_length).astype(np.int32)[None])
    js, jr = jfr.fused_rollout_hd(jfr.SoAState(*(jnp.asarray(a) for a in planes)), 2, length=T,
                                  ep_len=env.world_length, n=n, block=512, interpret=True)
    ts, tr = bench.k4_chunk(env, tfr.SoAState(*(torch.as_tensor(a) for a in planes)), 2, T)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=5e-6, atol=2e-3)
    for name in ("ap", "av", "ishape", "ivel"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
    assert int((np.asarray(js.t) < planes[4]).sum()) == int((planes[4] >= env.world_length - T).sum()) > 0


# -- row 2: bfs_state ---------------------------------------------------------------------

def _hd_state(n, B, seed, dtype=np.float32):
    """A formation_hd state made with numpy, first episode (t = 0)."""
    rng = np.random.RandomState(seed)
    apos = rng.uniform(-1, 1, (B, n, 2))
    ishape = rng.uniform(-1, 1, (B, n, 2))
    ishape -= ishape.mean(1, keepdims=True)
    cast = lambda a: np.asarray(a, dtype)
    return dict(
        pos=cast(np.concatenate([apos, ishape + apos.mean(1, keepdims=True)], 1)),
        vel=cast(np.concatenate([rng.uniform(-0.3, 0.3, (B, n, 2)), np.zeros((B, n, 2))], 1)),
        c=np.zeros((B, n, 2), dtype), ideal_shape=cast(ishape),
        ideal_vel=cast(rng.uniform(-1, 1, (B, 2))), t=np.zeros(B, np.int32),
    )


def _jax_state(st):
    B = st["pos"].shape[0]
    return JEnvState(**{k: jnp.asarray(v) for k, v in st.items()}, key=jax.random.split(jax.random.PRNGKey(0), B))


@pytest.mark.parametrize("n,B,T", [(9, 8, 6), (27, 4, 4)])
def test_row2_fused_route_matches_jax(n, B, T):
    """The bfs_state chunk on the fused route (policy "bfs_ez") against
    bench.py's ``rollout_statepolicy_fused(..., policy="bfs_ez")`` (the
    Pallas kernels in interpret mode).  Tolerances of
    tests/test_fused_step.py: pos 2e-4, vel 2e-3 (rtol 1e-4); the per-env
    reward sum is n·(n·(velterm − haus) − Σ counts) a step, so with counts
    exact and Hausdorff within 1e-5 it takes T·n²·1e-5 beside rtol 1e-4."""
    st = _hd_state(n, B, n)
    jenv = ft.make_env("formation_hd_env", num_agents=n)
    jfinal, jrew = ft.rollout_statepolicy_fused(jenv, None, _jax_state(st),
                                                jax.random.split(jax.random.PRNGKey(1), B), T,
                                                policy="bfs_ez", interpret=True)
    env = gt.make_env("formation_hd_env", num_agents=n)
    pol = bench.make_policy("bfs_state", env, "cpu")
    reset_counts = (fused_step.launches, reward_sym.launches)
    tfinal, trew = bench.statepolicy_chunk(env, gt.state_from_numpy(st), torch.Generator(), T, pol, "bfs_ez")
    assert (fused_step.launches, reward_sym.launches) == reset_counts  # plain versions on the CPU
    assert trew.shape == (T, B)
    np.testing.assert_allclose(trew.sum(0).numpy(), np.asarray(jrew).sum(0), rtol=1e-4, atol=T * n * n * 1e-5)
    np.testing.assert_allclose(tfinal.pos.numpy(), np.asarray(jfinal.pos), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(tfinal.t.numpy(), np.asarray(jfinal.t))


@pytest.mark.parametrize("n,B,T", [(9, 8, 6), (27, 4, 4)])
def test_row2_step_path_matches_jax(n, B, T):
    """The bfs_state chunk on the step path against bench.py's vmapped
    ``rollout_statepolicy_rewardsum`` under ``bfs_actions_from_state``.
    Tolerances of tests/test_torch_env.py's step slice: pos 2e-4, vel 2e-3,
    per-step rewards atol 1e-4 rtol 1e-5, here summed over T steps and n
    agents."""
    st = _hd_state(n, B, n + 1)
    jenv = ft.make_env("formation_hd_env", num_agents=n)
    jpol = lambda s, k: ft.bfs_actions_from_state(ft.ezpolicy_batched, jenv.scenario, s, 3)
    jfinal, jsum = jax.jit(jax.vmap(lambda s, k: ft.rollout_statepolicy_rewardsum(jenv, jpol, s, k, T)))(
        _jax_state(st), jax.random.split(jax.random.PRNGKey(1), B))
    env = gt.make_env("formation_hd_env", num_agents=n)
    pol = bench.make_policy("bfs_state", env, "cpu")
    tfinal, tsum = bench.statepolicy_chunk(env, gt.state_from_numpy(st), torch.Generator(), T, pol)
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=1e-5, atol=T * n * 1e-4)
    np.testing.assert_allclose(tfinal.pos.numpy(), np.asarray(jfinal.pos), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(tfinal.t.numpy(), np.asarray(jfinal.t))


# -- row 3 and the other observation policies ------------------------------------------------

OBS_ROWS = {
    "ezpolicy_basic": ("basic_formation_env", 3, "ezpolicy"),
    "ezpolicy_hd": ("formation_hd_env", 3, "ezpolicy"),
    "bfs_hd": ("formation_hd_env", 9, "bfs"),
    "linear_partial": ("formation_hd_partial_env", 4, "linear"),
}


def _scen_state(scen, B, seed):
    """A float64 state of ``scen`` made with numpy, first episode."""
    cfg, n = scen.cfg, scen.cfg.n_agents
    rng = np.random.RandomState(seed)
    ishape = rng.uniform(-1, 1, (B, cfg.n_landmarks, 2))
    return dict(
        pos=rng.uniform(-1, 1, (B, cfg.n_entities, 2)),
        vel=np.concatenate([rng.uniform(-0.3, 0.3, (B, n, 2)), np.zeros((B, cfg.n_entities - n, 2))], 1),
        c=np.zeros((B, n, cfg.dim_c)),
        ideal_shape=ishape - ishape.mean(1, keepdims=True),
        ideal_vel=rng.uniform(-1, 1, (B, 2)),
        t=np.zeros(B, np.int32),
    )


@pytest.mark.parametrize("row", sorted(OBS_ROWS))
def test_obs_rows_match_jax_f64(row):
    """The observation chunk (row 3 is basic_formation under ezpolicy)
    against bench.py's vmapped ``rollout`` with ``outs.reward`` summed, in
    float64 on the same injected state, 5 steps of the first episode; the
    linear policy's W injected into both.  Reward sums and the final state
    within rtol = atol = 1e-9 (float64: only the order of sums differs)."""
    name, n, policy = OBS_ROWS[row]
    B, T = 4, 5
    jscen = ft.make_scenario(name, num_agents=n, dtype=jnp.float64)
    tscen = gt.make_scenario(name, num_agents=n, dtype=F64)
    st = _scen_state(tscen, B, 11)
    jenv, env = ft.FormationEnv(jscen), gt.FormationEnv(tscen)
    W = np.random.RandomState(3).normal(size=(tscen.obs_dim, env.act_dim)) / np.sqrt(tscen.obs_dim)
    if policy == "ezpolicy":
        jpol = lambda o, k: ft.ezpolicy_batched(o)
    elif policy == "bfs":
        jpol = lambda o, k: ft.bfs_actions(ft.ezpolicy_batched, o, 3)
    else:
        jpol = lambda o, k: jnp.clip(o @ jnp.asarray(W), -1.0, 1.0)
    jst = jax.vmap(jscen.pre_obs)(_jax_state(st))
    (jfinal, _), outs = jax.jit(jax.vmap(lambda s, o, k: ft.rollout(jenv, jpol, s, o, k, T)))(
        jst, jax.vmap(jscen.observe)(jst), jax.random.split(jax.random.PRNGKey(1), B))
    pol = bench.make_policy(policy, env, "cpu", W=torch.as_tensor(W))
    state = tscen.pre_obs(gt.state_from_numpy(st, dtype=F64))
    k1 = pairforce_sym.launches
    tfinal, tobs, tsum = bench.obs_chunk(env, state, tscen.observe(state), torch.Generator(), T, pol)
    assert pairforce_sym.launches == k1 and tsum.dtype == F64
    np.testing.assert_allclose(tsum.numpy(), np.asarray(outs.reward).sum((1, 2)), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tfinal.pos.numpy(), np.asarray(jfinal.pos), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jax.vmap(jscen.observe)(jfinal)), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(tfinal.t.numpy(), np.asarray(jfinal.t))


def test_random_policy_draws_from_the_runs_generator():
    """Uniform in [-1, 1), of the env's action width, and the same draws
    from the same generator state."""
    env = gt.make_env("formation_hd_env", num_agents=3)
    pol = bench.make_policy("random", env, "cpu")
    g = torch.Generator()
    obs = torch.zeros(64, 3, env.scenario.obs_dim)
    g.manual_seed(4)
    a = pol(obs, g)
    g.manual_seed(4)
    assert a.shape == (64, 3, env.act_dim) and torch.equal(a, pol(obs, g))
    assert float(a.min()) >= -1.0 and float(a.max()) < 1.0 and float(a.min()) < -0.9
    with pytest.raises(ValueError, match="unknown policy"):
        bench.make_policy("mlp", env, "cpu")


def test_linear_weights_are_seeded_and_scaled():
    """chip_smoke.py: linear_policy's W (numpy's normal seeded by 7), scaled
    by 1/sqrt(obs_dim)."""
    W = bench.linear_weights(400, 2, "cpu")
    want = np.random.RandomState(7).normal(size=(400, 2)) / 20.0
    np.testing.assert_array_equal(W.numpy(), want.astype(np.float32))
    assert torch.equal(W, bench.linear_weights(400, 2, "cpu"))
    assert W.shape == (400, 2) and W.dtype == torch.float32
    assert abs(float(W.std()) * 20.0 - 1.0) < 0.1  # 1/sqrt(400) of a unit normal


# -- entry() -------------------------------------------------------------------------------

def test_entry_matches_jax_entry():
    """The root __graft_entry__.entry()'s parameters converted into the
    port's forward: (mean, value) on JAX's observations within 1e-5; the
    port's own example arguments of the same shapes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("graft_root", os.path.join(REPO, "__graft_entry__.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    jfn, (jparams, jobs) = root.entry()
    jmean, jvalue = jax.jit(jfn)(jparams, jobs)

    from gym_formation_tpu_torch.graft_entry import entry

    fn, (params, obs) = entry(device="cpu")
    nets = {"actor": actor_from_flax(jparams["actor"]), "critic": critic_from_flax(jparams["critic"])}
    conv = {k: dict(net.named_parameters()) for k, net in nets.items()}
    assert {k: {m: tuple(p.shape) for m, p in v.items()} for k, v in conv.items()} == {
        k: {m: tuple(p.shape) for m, p in v.items()} for k, v in params.items()}
    with torch.no_grad():
        mean, value = fn(conv, torch.as_tensor(np.array(jobs), dtype=torch.float32))
        own = fn(params, obs)
    assert obs.shape == jobs.shape == (64, 9, 54)
    assert tuple(own[0].shape) == jmean.shape == (64, 9, 2) and tuple(own[1].shape) == jvalue.shape == (64,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=1e-5)


def test_new_modules_import_no_jax():
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", "import sys\n"
                        "import gym_formation_tpu_torch.bench, gym_formation_tpu_torch.graft_entry\n"
                        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'gym_formation_tpu') "
                        "or m.startswith(('jax.', 'flax.', 'gym_formation_tpu.'))]\n"
                        "assert not bad, bad\n"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
