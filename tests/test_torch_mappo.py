"""The port's MAPPO against the JAX package's on the same inputs.

- networks, ``_loss`` and every autograd gradient leaf against flax and
  ``jax.grad(MAPPO._loss)`` in float64 (1e-10), with and without
  ``auto_entropy``;
- ``_gae``, ``ValueNorm.update`` and ``_prepare`` on one trajectory, and
  ``_update`` (3 epochs; one minibatch, and two with the JAX permutation
  passed in) in float64;
- eight iterations in lockstep with JAX: ``_collect`` on JAX's actions,
  and ``_prepare`` + ``_update`` carrying the value norm and Adam across
  iterations and an episode end;
- the slice as a whole: one ``train_step`` with K5 and K9 (their plain
  versions here, the JAX Pallas kernels in interpret mode) from the same
  networks, env state and K5 seed;
- ``grad_accum``/``remat``, the auto gates, learning, checkpoints and the
  ``train`` entry point of the port.
"""

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
from gym_formation_tpu.algos import MAPPO as JMAPPO, MAPPOConfig as JMAPPOConfig
from gym_formation_tpu.algos.mappo import ValueNorm as JValueNorm
from gym_formation_tpu.models.networks import gaussian_logp as jgaussian_logp

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import train as ttrain
from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig
from gym_formation_tpu_torch.algos.mappo import ValueNorm
from gym_formation_tpu_torch.models.networks import to_flax, to_flax_tree
from gym_formation_tpu_torch.utils import restore_checkpoint, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _jenv(n=3, ep=100):
    return ft.FormationEnv(ft.make_env("formation_hd_env", num_agents=n, episode_length=ep).scenario)


def _tenv(n=3, ep=100):
    return gt.make_env("formation_hd_env", num_agents=n, episode_length=ep)


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees(got, want, rtol, atol):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


def _params_tree(ts):
    tree = {"actor": to_flax(ts.actor), "critic": to_flax(ts.critic)}
    if ts.log_alpha is not None:
        tree["log_alpha"] = ts.log_alpha.detach().numpy()
    return tree


def _grads_tree(ts, grads):
    na, nc = len(list(ts.actor.parameters())), len(list(ts.critic.parameters()))
    names = lambda m: [k for k, _ in m.named_parameters()]
    tree = {"actor": to_flax_tree(dict(zip(names(ts.actor), grads[:na]))),
            "critic": to_flax_tree(dict(zip(names(ts.critic), grads[na:na + nc])))}
    if ts.log_alpha is not None:
        tree["log_alpha"] = grads[-1].detach().numpy()
    return tree


def _make_batch(jalgo, params, M, seed):
    """A flat batch in the JAX tests' manner: obs at the reset scale, actions
    from the policy, behaviour logp jittered so that the ratios spread
    around 1 and every clip/min branch is taken."""
    rng = np.random.RandomState(seed)
    n, do = jalgo.n_agents, jalgo.obs_dim
    obs = jnp.asarray(rng.uniform(-1.5, 1.5, (M, n, do)))
    mean, ls = jalgo.actor.apply(params["actor"], obs)
    action = mean + jnp.exp(ls) * rng.normal(size=mean.shape)
    logp = jgaussian_logp(mean, ls, action) + 0.2 * rng.normal(size=(M, n))
    value = jalgo.critic.apply(params["critic"], obs.reshape(M, n * do))
    return {"obs": obs, "action": action, "logp": logp, "value": value,
            "target": value + rng.normal(size=M), "adv": jnp.asarray(rng.normal(size=M))}


def _torch(batch, dtype=F64):
    return {k: torch.as_tensor(np.array(v), dtype=dtype) for k, v in batch.items()}


def _setup(cfg_kw, M=64, T=8):
    jalgo = JMAPPO(_jenv(), JMAPPOConfig(rollout_len=T, **cfg_kw), num_envs=M // T)
    ts_j, _, _ = jalgo.init(jax.random.PRNGKey(0))
    p64 = _f64(ts_j.params)
    talgo = MAPPO(_tenv(), MAPPOConfig(rollout_len=T, **cfg_kw), num_envs=M // T, device="cpu", dtype=F64)
    return jalgo, ts_j, p64, talgo


def test_networks_match_flax():
    jalgo, _, p64, talgo = _setup({})
    ts = talgo.state_from_flax(_np(p64))
    obs = np.random.RandomState(0).uniform(-1.5, 1.5, (5, 3, 18))
    mean_j, ls_j = jalgo.actor.apply(p64["actor"], jnp.asarray(obs))
    v_j = jalgo.critic.apply(p64["critic"], jnp.asarray(obs.reshape(5, -1)))
    with torch.no_grad():
        mean_t, ls_t = ts.actor(torch.as_tensor(obs))
        v_t = ts.critic(torch.as_tensor(obs.reshape(5, -1)))
    for got, want in ((mean_t, mean_j), (ls_t, ls_j), (v_t, v_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)
    _assert_trees(_params_tree(ts), p64, 0, 0)  # the carry-over round trip is exact


@pytest.mark.parametrize("auto_entropy", [False, True])
def test_loss_and_grads_match_jax(auto_entropy):
    """_loss, its metrics and every gradient leaf (float64, 1e-10)."""
    jalgo, _, p64, talgo = _setup(dict(auto_entropy=auto_entropy))
    if auto_entropy:
        p64["log_alpha"] = jnp.asarray(0.03)  # inside the clip, so α and its gradient both act
    batch = _make_batch(jalgo, p64, 64, 1)
    (total_j, met_j), g_j = jax.value_and_grad(jalgo._loss, has_aux=True)(p64, batch, JValueNorm.create())
    ts = talgo.state_from_flax(_np(p64))
    total_t, met_t = talgo._loss(ts, _torch(batch), ts.value_norm)
    grads = torch.autograd.grad(total_t, ts.params())
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=1e-10, atol=1e-10)
    assert sorted(met_t) == sorted(met_j)
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k].detach()), float(met_j[k]), rtol=1e-10, atol=1e-10, err_msg=k)
    _assert_trees(_grads_tree(ts, grads), g_j, 1e-10, 1e-10)


def _trajectory(T, B, n, seed):
    rng = np.random.RandomState(seed)
    return {
        "obs": rng.uniform(-1, 1, (T, B, n, 6 * n)), "action": rng.normal(size=(T, B, n, 2)),
        "logp": rng.normal(size=(T, B, n)), "value": rng.normal(size=(T, B)),
        "reward": rng.normal(size=(T, B)) - 3.0, "done": rng.uniform(size=(T, B)) < 0.2,
    }, rng.normal(size=B)


def test_gae_valuenorm_prepare_match_jax():
    T, B = 5, 6
    jalgo = JMAPPO(_jenv(), JMAPPOConfig(rollout_len=T), num_envs=B)
    ts_j, _, _ = jalgo.init(jax.random.PRNGKey(0))
    ts_j = ts_j.replace(value_norm=JValueNorm(mean=jnp.asarray(0.3), mean_sq=jnp.asarray(1.5),
                                              count=jnp.asarray(10.0)))
    traj, last = _trajectory(T, B, 3, 2)
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    adv_j, ret_j = jalgo._gae(ts_j, jtraj, jnp.asarray(last))
    ts_j2, data_j = jalgo._prepare(ts_j, jtraj, jnp.asarray(last))

    talgo = MAPPO(_tenv(), MAPPOConfig(rollout_len=T), num_envs=B, device="cpu", dtype=F64)
    ts = talgo.state_from_flax(_np(_f64(ts_j.params)))
    ts.value_norm = ValueNorm(*(torch.tensor(v, dtype=F64) for v in (0.3, 1.5, 10.0)))
    ttraj = {k: torch.as_tensor(v) for k, v in traj.items()}
    adv_t, ret_t = talgo._gae(ts, ttraj, torch.as_tensor(last))
    ts, data_t = talgo._prepare(ts, ttraj, torch.as_tensor(last))
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ret_t.numpy(), np.asarray(ret_j), rtol=1e-12, atol=1e-12)
    for k in ("mean", "mean_sq", "count"):
        np.testing.assert_allclose(float(getattr(ts.value_norm, k)), float(getattr(ts_j2.value_norm, k)),
                                   rtol=1e-12, err_msg=k)
    assert sorted(data_t) == sorted(data_j)
    for k in data_j:
        np.testing.assert_allclose(data_t[k].numpy(), np.asarray(data_j[k]), rtol=1e-10, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("num_minibatches", [1, 2])
def test_update_matches_jax(num_minibatches):
    """One _update of 3 epochs: the parameters after it (1e-9) and the
    metrics; at two minibatches the JAX permutations are passed in."""
    kw = dict(ppo_epochs=3, num_minibatches=num_minibatches)
    jalgo, ts_j, p64, talgo = _setup(kw)
    ts_j = ts_j.replace(params=p64, opt_state=jalgo.tx.init(p64), value_norm=JValueNorm.create())
    batch = _make_batch(jalgo, p64, 64, 3)
    key = jax.random.PRNGKey(2)
    ts_j2, m_j = jalgo._update(ts_j, batch, key)
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, 64)))
             for k in jax.random.split(key, 3)]
    ts = talgo.state_from_flax(_np(p64))
    ts, m_t = talgo._update(ts, _torch(batch), None, perms=perms)
    _assert_trees(_params_tree(ts), ts_j2.params, 1e-9, 1e-9)
    assert ts.opt_state.count == int(ts_j2.opt_state[1][0].count)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-9, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("lever", [dict(grad_accum=2), dict(remat=True), dict(grad_accum=4, remat=True)])
def test_grad_accum_and_remat_match_whole_batch(lever):
    """grad_accum chunks and remat change no number beyond float64
    reassociation; the metric keys (alpha included) come from the loss."""
    base = dict(ppo_epochs=2, auto_entropy=True)
    jalgo, _, p64, talgo = _setup(base)
    batch = _torch(_make_batch(jalgo, p64, 64, 4))
    out = {}
    for tag, kw in (("plain", {}), ("lever", lever)):
        algo = MAPPO(_tenv(), MAPPOConfig(rollout_len=8, **base, **kw), num_envs=8, device="cpu", dtype=F64)
        ts = algo.state_from_flax(_np(p64))
        ts, m = algo._update(ts, batch)
        out[tag] = (_params_tree(ts), {k: float(v) for k, v in m.items()})
    _assert_trees(out["lever"][0], out["plain"][0], 1e-10, 1e-12)
    assert sorted(out["lever"][1]) == sorted(out["plain"][1]) == sorted(
        ["pg_loss", "v_loss", "entropy", "approx_kl", "alpha"])
    for k, v in out["plain"][1].items():
        np.testing.assert_allclose(out["lever"][1][k], v, rtol=1e-10, atol=1e-12, err_msg=k)


def test_fully_fused_train_step_matches_jax():
    """The slice as a whole: n=3, B=32, T=8, two epochs, fused collection and
    fused update on both sides (JAX in interpret mode, the port's plain
    versions), the same networks, env state and K5 seed.  Parameters after
    one iteration to rtol 5e-3, atol 5e-5 and v_loss to rtol 1e-3 (the
    tolerances of tests/test_fused_ppo_grad.py's one-step match)."""
    cfg = dict(rollout_len=8, ppo_epochs=2, fused_collect=True, fused_update=True)
    jalgo = JMAPPO(_jenv(ep=25), JMAPPOConfig(**cfg), num_envs=32)
    ts_j, es_j, obs_j = jalgo.init(jax.random.PRNGKey(0))
    params0, state0 = _np(ts_j.params), _np(es_j)
    key = jax.random.PRNGKey(7)
    # the seed JAX's _collect_fused draws from this key
    k_roll = jax.random.split(key)[0]
    k_seed = jax.random.split(k_roll, 3)[1]
    seed = int(jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max))
    ts_j2, _, _, m_j = jalgo.train_step(ts_j, es_j, obs_j, key)

    talgo = MAPPO(_tenv(ep=25), MAPPOConfig(**cfg), num_envs=32, device="cpu")
    assert talgo.fused_collect
    ts = talgo.state_from_flax(params0)
    talgo._next_seed = lambda: seed
    ts, es, obs, m_t = talgo.train_step(ts, gt.state_from_numpy(state0), None, torch.Generator())
    _assert_trees(_params_tree(ts), _np(ts_j2.params), 5e-3, 5e-5)
    np.testing.assert_allclose(float(m_t["v_loss"]), float(m_j["v_loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(m_t["mean_step_reward"]), float(m_j["mean_step_reward"]), rtol=1e-4)
    assert obs.shape == (32, 3, 18) and int(es.t[0]) == 8


def test_iterations_in_lockstep_with_jax():
    """Eight iterations of B=32, T=25 on episodes of 100 (every fourth
    collection ends the episodes), JAX collecting: the port's _collect on
    JAX's actions and env state gives JAX's trajectory (float32, 1e-4), and
    its _prepare + _update on JAX's trajectory carry the value norm and
    Adam across the iterations as JAX does (float64, 1e-12)."""
    jalgo = JMAPPO(_jenv(), JMAPPOConfig(), num_envs=32)
    ts_j, es_j, obs_j = jalgo.init(jax.random.PRNGKey(1))
    ts_j = ts_j.replace(params=_f64(ts_j.params))
    ts_j = ts_j.replace(opt_state=jalgo.tx.init(ts_j.params))
    collect, prepare, update = (jax.jit(f) for f in (jalgo._collect, jalgo._prepare, jalgo._update))
    talgo = MAPPO(_tenv(), MAPPOConfig(), num_envs=32, device="cpu", dtype=F64)
    ts = talgo.state_from_flax(_np(ts_j.params))
    replay = MAPPO(_tenv(), MAPPOConfig(), num_envs=32, device="cpu")
    key = jax.random.PRNGKey(5)
    for _ in range(8):
        key, k1, k2 = jax.random.split(key, 3)
        state0, obs0 = _np(es_j), np.array(obs_j)
        es_j, obs_j, traj, _, last = collect(ts_j, es_j, obs_j, k1)
        acts = iter(torch.as_tensor(np.array(a), dtype=torch.float32) for a in traj["action"])
        replay._dist_sample = lambda g, dist: next(acts)
        with torch.no_grad():
            _, _, got, _, _ = replay._collect(replay.state_from_flax(_np(ts_j.params)), gt.state_from_numpy(state0),
                                              torch.as_tensor(obs0, dtype=torch.float32), torch.Generator())
        for k in ("obs", "logp", "value", "reward", "done"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(traj[k]), rtol=0, atol=1e-4, err_msg=k)
        ts_j, data_j = prepare(ts_j, traj, last)
        ts_j, _ = update(ts_j, data_j, k2)
        ttraj = {k: torch.as_tensor(np.array(v)) for k, v in traj.items()}
        ttraj = {k: v.to(F64) if v.is_floating_point() else v for k, v in ttraj.items()}
        ts, data = talgo._prepare(ts, ttraj, torch.as_tensor(np.array(last), dtype=F64))
        ts, _ = talgo._update(ts, data)
        _assert_trees(_params_tree(ts), ts_j.params, 1e-12, 1e-12)
        np.testing.assert_allclose(float(ts.value_norm.mean), float(ts_j.value_norm.mean), rtol=1e-12)
    assert ts.opt_state.count == 80


def test_train_step_runs_and_learns():
    """The non-fused port (step-by-step collection, autograd update): finite
    metrics and a reward that has not collapsed after 12 short iterations
    (the loose band of tests/test_fused_collect.py)."""
    algo = MAPPO(_tenv(ep=25), MAPPOConfig(rollout_len=8, ppo_epochs=2, entropy_coef=0.0), num_envs=32, device="cpu")
    assert not algo.fused_collect and not algo.structured_obs
    g = torch.Generator()
    g.manual_seed(0)
    ts, es, obs = algo.init(g)
    first = None
    for _ in range(12):
        ts, es, obs, m = algo.train_step(ts, es, obs, g)
        r = float(m["mean_step_reward"])
        assert np.isfinite(r) and np.isfinite(float(m["v_loss"]))
        first = r if first is None else first
    assert r > first - 2.0, (first, r)
    assert ts.update_i == 12


def test_benchmark_means_are_logged():
    env = gt.make_env("formation_hd_env", num_agents=3, benchmark=True)
    algo = MAPPO(env, MAPPOConfig(rollout_len=3, ppo_epochs=1), num_envs=4, device="cpu")
    g = torch.Generator()
    ts, es, obs = algo.init(g)
    _, _, _, m = algo.train_step(ts, es, obs, g)
    for k in ("bench_reward", "bench_collisions", "bench_min_dists", "bench_occupied_landmarks"):
        assert np.isfinite(float(m[k])), k


def test_auto_gates(monkeypatch):
    """fused_collect: on for hd at n in K5's instantiations on a CUDA device
    (the JAX gate's batch multiple of 512 dropped), off on the CPU, with
    benchmark info or without auto-reset.  structured_obs as the JAX gate.
    The gates read only the device's type, so a card is simulated."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    hd3 = _tenv()
    assert MAPPO(hd3, MAPPOConfig(), num_envs=4, device="cuda").fused_collect
    assert MAPPO(hd3, MAPPOConfig(), num_envs=100, device="cuda").fused_collect
    assert not MAPPO(hd3, MAPPOConfig(), num_envs=4, device="cpu").fused_collect
    assert not MAPPO(_tenv(5), MAPPOConfig(), num_envs=4, device="cuda").fused_collect
    bench = gt.make_env("formation_hd_env", num_agents=3, benchmark=True)
    assert not MAPPO(bench, MAPPOConfig(), num_envs=4, device="cuda").fused_collect
    assert MAPPO(hd3, MAPPOConfig(fused_collect=True), num_envs=4, device="cpu").fused_collect  # forced: plain K5
    big = _tenv(81)
    assert MAPPO(big, MAPPOConfig(), num_envs=4, device="cpu").structured_obs
    assert not MAPPO(_tenv(31), MAPPOConfig(), num_envs=4, device="cpu").structured_obs
    assert not MAPPO(big, MAPPOConfig(fused_update=True), num_envs=4, device="cpu").structured_obs
    structured = MAPPO(big, MAPPOConfig(), num_envs=4, device="cuda")
    assert structured.structured_obs and not structured.fused_collect
    with pytest.raises(AssertionError):
        MAPPO(big, MAPPOConfig(fused_update=True, structured_obs=True), num_envs=4, device="cpu")
    with pytest.raises(AssertionError):
        MAPPO(hd3, MAPPOConfig(fused_update=True, auto_entropy=True), num_envs=4, device="cpu")
    separated = MAPPO(hd3, MAPPOConfig(share_policy=False), num_envs=4, device="cuda")
    assert not separated.fused_collect and not separated.structured_obs


def test_checkpoint_restore_continues_exactly(tmp_path):
    """Save after 2 iterations, restore into fresh objects, and the third
    iteration equals the uninterrupted run's bit for bit (K5's seed
    generator and the minibatch permutations' generator included)."""
    cfg = MAPPOConfig(rollout_len=4, ppo_epochs=2, num_minibatches=2, fused_collect=True)

    def fresh():
        g = torch.Generator()
        g.manual_seed(3)
        algo = MAPPO(_tenv(ep=6), cfg, num_envs=8, device="cpu")
        return algo, g, algo.init(g)

    algo, g, (ts, es, obs) = fresh()
    for _ in range(2):
        ts, es, obs, _ = algo.train_step(ts, es, obs, g)
    save_checkpoint(str(tmp_path), 2, algo.checkpoint_tree(ts, es, obs, g))
    ts, es, obs, m = algo.train_step(ts, es, obs, g)

    algo2 = MAPPO(_tenv(ep=6), cfg, num_envs=8, device="cpu")
    g2 = torch.Generator()
    g2.manual_seed(99)
    ts2, es2, obs2 = algo2.restore_tree(restore_checkpoint(str(tmp_path)), g2)
    assert ts2.update_i == 2
    ts2, es2, obs2, m2 = algo2.train_step(ts2, es2, obs2, g2)
    for a, b in zip(ts.params(), ts2.params()):
        assert torch.equal(a, b)
    assert torch.equal(es.pos, es2.pos) and torch.equal(obs, obs2)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m2.items()}


def _run_train(args, run_dir):
    cmd = [sys.executable, "-m", "gym_formation_tpu_torch.train", "--device", "cpu", "--num-envs", "8",
           "--log-every", "1", "--save-every", "1", "--run-dir", str(run_dir),
           "--set", "rollout_len=4", "--set", "ppo_epochs=1", *args]
    return subprocess.run(cmd, cwd=REPO, check=True, timeout=300, capture_output=True, text=True)


def test_train_entry_point_cpu(tmp_path):
    """Two iterations with a checkpoint each, then a restored third; the
    metrics file has the JAX package's keys."""
    run = tmp_path / "run"
    _run_train(["--iters", "2"], run)
    out = _run_train(["--iters", "1", "--restore"], run)
    assert "restored checkpoint at iteration 2" in out.stdout
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [32, 64, 96]
    keys = {"step", "wall", "pg_loss", "v_loss", "entropy", "approx_kl", "mean_step_reward"}
    assert all(set(r) == keys for r in rows)
    assert sorted(os.listdir(run / "ckpt")) == ["2.pt", "3.pt"]


def test_train_entry_point_refuses(tmp_path):
    with pytest.raises(SystemExit, match="--restore: no checkpoint"):
        ttrain.main(["--algo", "rmaddpg", "--device", "cpu", "--restore", "--run-dir", str(tmp_path / "none")])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            ttrain.main(["--iters", "1"])


def test_load_config_overrides():
    from gym_formation_tpu_torch.utils import load_config

    cfg = load_config(MAPPOConfig, None, ["ppo_epochs=3", "lr=0.001", "fused_update=true"])
    assert (cfg.ppo_epochs, cfg.lr, cfg.fused_update) == (3, 0.001, True)
    with pytest.raises(ValueError, match="unknown config keys"):
        load_config(MAPPOConfig, None, ["ppo_epoch=3"])
    with pytest.raises(ValueError, match="key=value"):
        load_config(MAPPOConfig, None, ["ppo_epochs"])
