"""The port's MAPPO with the categorical head and with per-agent networks
(``share_policy=False``) against the JAX package's, in float64 on the same
parameters and numpy batches:

- ``_loss``, its metrics and every gradient leaf (1e-10);
- ``_gae`` and ``_prepare`` with per-agent values (1e-10);
- one ``_update`` of 3 epochs with JAX's permutations passed in (1e-9);
- the gates and the raises of the kernel paths;
- the JAX package's behaviour tests of these heads, ported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MAPPO as JMAPPO, MAPPOConfig as JMAPPOConfig
from gym_formation_tpu.algos.mappo import ValueNorm as JValueNorm

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig, RMAPPO, RMAPPOConfig
from gym_formation_tpu_torch.models.networks import to_flax, to_flax_tree

F64 = torch.float64
# (discrete env, share_policy)
KINDS = {"discrete": (True, True), "separated": (False, False), "separated_discrete": (True, False)}


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
    return {"actor": to_flax(ts.actor), "critic": to_flax(ts.critic)}


def _grads_tree(ts, grads):
    na = len(list(ts.actor.parameters()))
    names = lambda m: [k for k, _ in m.named_parameters()]
    return {"actor": to_flax_tree(dict(zip(names(ts.actor), grads[:na]))),
            "critic": to_flax_tree(dict(zip(names(ts.critic), grads[na:])))}


def _setup(kind, M=64, T=8, **cfg_kw):
    discrete, share = KINDS[kind]
    kw = dict(rollout_len=T, share_policy=share, **cfg_kw)
    jenv = ft.FormationEnv(ft.make_env("formation_hd_env", num_agents=3, discrete_action=discrete).scenario,
                           discrete_action=discrete)
    jalgo = JMAPPO(jenv, JMAPPOConfig(**kw), num_envs=M // T)
    ts_j, _, _ = jalgo.init(jax.random.PRNGKey(0))
    p64 = _f64(ts_j.params)
    # head gains up, so that the policy's distribution is far from uniform
    p64["actor"]["params"]["Dense_0"]["kernel"] = p64["actor"]["params"]["Dense_0"]["kernel"] * 100.0
    talgo = MAPPO(gt.make_env("formation_hd_env", num_agents=3, discrete_action=discrete), MAPPOConfig(**kw),
                  num_envs=M // T, device="cpu", dtype=F64)
    return jalgo, ts_j, p64, talgo


def _make_batch(jalgo, params, M, seed):
    """A flat batch: obs at the reset scale, actions drawn from the policy
    with numpy, the behaviour logp jittered so that the ratios spread
    around 1 and every clip/min branch is taken; per-agent value, target
    and advantage where the critics are per agent."""
    rng = np.random.RandomState(seed)
    n, do = jalgo.n_agents, jalgo.obs_dim
    obs = jnp.asarray(rng.uniform(-1.5, 1.5, (M, n, do)))
    dist = jalgo._apply_actor(params["actor"], obs)
    if jalgo.discrete:
        gumbel = -np.log(-np.log(rng.uniform(size=dist.shape)))
        action = jnp.asarray(np.eye(dist.shape[-1])[np.argmax(np.asarray(dist) + gumbel, -1)])
    else:
        action = dist[0] + jnp.exp(dist[1]) * rng.normal(size=dist[0].shape)
    logp = jalgo._dist_logp(dist, action) + 0.2 * rng.normal(size=(M, n))
    value = jalgo._apply_critic(params["critic"], obs.reshape(M, n * do))
    return {"obs": obs, "action": action, "logp": logp, "value": value,
            "target": value + rng.normal(size=value.shape), "adv": jnp.asarray(rng.normal(size=value.shape))}


def _torch(batch):
    return {k: torch.as_tensor(np.array(v), dtype=F64) for k, v in batch.items()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_and_grads_match_jax(kind):
    jalgo, _, p64, talgo = _setup(kind)
    batch = _make_batch(jalgo, p64, 64, 1)
    (total_j, met_j), g_j = jax.value_and_grad(jalgo._loss, has_aux=True)(p64, batch, JValueNorm.create())
    ts = talgo.state_from_flax(_np(p64))
    _assert_trees(_params_tree(ts), p64, 0, 0)
    total_t, met_t = talgo._loss(ts, _torch(batch), ts.value_norm)
    grads = torch.autograd.grad(total_t, ts.params())
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=1e-10, atol=1e-10)
    assert sorted(met_t) == sorted(met_j)
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k].detach()), float(met_j[k]), rtol=1e-10, atol=1e-10, err_msg=k)
    _assert_trees(_grads_tree(ts, grads), g_j, 1e-10, 1e-10)


def test_per_agent_gae_and_prepare_match_jax():
    """Per-agent values [T, B, N]: reward and done broadcast over the agent
    axis in GAE; the flat batch keeps the agent axis."""
    T, B, n = 5, 6, 3
    jalgo, ts_j, _, _ = _setup("separated", M=T * B, T=T)
    talgo = MAPPO(gt.make_env("formation_hd_env", num_agents=n), MAPPOConfig(rollout_len=T, share_policy=False),
                  num_envs=B, device="cpu", dtype=F64)
    rng = np.random.RandomState(2)
    traj = {"obs": rng.uniform(-1, 1, (T, B, n, 6 * n)), "action": rng.normal(size=(T, B, n, 2)),
            "logp": rng.normal(size=(T, B, n)), "value": rng.normal(size=(T, B, n)),
            "reward": rng.normal(size=(T, B)) - 3.0, "done": rng.uniform(size=(T, B)) < 0.2}
    last = rng.normal(size=(B, n))
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    adv_j, ret_j = jalgo._gae(ts_j, jtraj, jnp.asarray(last))
    _, data_j = jalgo._prepare(ts_j, jtraj, jnp.asarray(last))
    ts = talgo.state_from_flax(_np(_f64(ts_j.params)))
    ttraj = {k: torch.as_tensor(v) for k, v in traj.items()}
    adv_t, ret_t = talgo._gae(ts, ttraj, torch.as_tensor(last))
    _, data_t = talgo._prepare(ts, ttraj, torch.as_tensor(last))
    assert adv_t.shape == (T, B, n)
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ret_t.numpy(), np.asarray(ret_j), rtol=1e-12, atol=1e-12)
    assert sorted(data_t) == sorted(data_j)
    for k in data_j:
        np.testing.assert_allclose(data_t[k].numpy(), np.asarray(data_j[k]), rtol=1e-10, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_update_matches_jax(kind):
    """One _update of 3 epochs at two minibatches, JAX's permutations
    passed in: the parameters after it (1e-9) and the metrics."""
    jalgo, ts_j, p64, talgo = _setup(kind, ppo_epochs=3, num_minibatches=2)
    ts_j = ts_j.replace(params=p64, opt_state=jalgo.tx.init(p64), value_norm=JValueNorm.create())
    batch = _make_batch(jalgo, p64, 64, 3)
    key = jax.random.PRNGKey(2)
    ts_j2, m_j = jalgo._update(ts_j, batch, key)
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, 64))) for k in jax.random.split(key, 3)]
    ts = talgo.state_from_flax(_np(p64))
    ts, m_t = talgo._update(ts, _torch(batch), None, perms=perms)
    _assert_trees(_params_tree(ts), ts_j2.params, 1e-9, 1e-9)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-9, atol=1e-9, err_msg=k)


def test_gates_and_raises(monkeypatch):
    """K5 and the structured path stay off for the categorical head and for
    per-agent networks (a card simulated: the gates read the device type
    only); a forced K5, K9 or structured path raises there, as JAX asserts,
    and so does any forced one on RMAPPO, whose gates stay off."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    hd3 = gt.make_env("formation_hd_env", num_agents=3)
    disc3 = gt.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    big, disc_big = (gt.make_env("formation_hd_env", num_agents=81, discrete_action=d) for d in (False, True))
    build = lambda env, **kw: MAPPO(env, MAPPOConfig(**kw), num_envs=4, device="cuda")
    assert build(hd3).fused_collect and build(big).structured_obs
    for algo in (build(disc3), build(hd3, share_policy=False), build(disc_big),
                 build(big, share_policy=False)):
        assert not algo.fused_collect and not algo.structured_obs
    assert build(disc3).discrete and not build(gt.make_env("formation_hd_env", discrete_action_input=True)).discrete
    for flag in ("fused_collect", "structured_obs", "fused_update"):
        for env, kw in ((disc3, {}), (hd3, dict(share_policy=False)), (disc_big, {})):
            with pytest.raises(ValueError, match=flag):
                build(env, **{flag: True}, **kw)
        with pytest.raises(ValueError, match="RMAPPO"):
            RMAPPO(hd3, RMAPPOConfig(**{flag: True}), num_envs=4, device="cuda")
    for env in (hd3, big):
        r = RMAPPO(env, RMAPPOConfig(), num_envs=4, device="cuda")
        assert not r.fused_collect and not r.structured_obs
    with pytest.raises(ValueError, match="entropy_target"):
        build(disc3, auto_entropy=True)
    assert build(disc3, auto_entropy=True, entropy_target=0.5).entropy_target == 0.5


def test_mappo_separated_policy():
    """JAX ``test_mappo_separated_policy``: stacked per-agent kernels, a
    finite iteration, actions [B, N, 2]."""
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3), MAPPOConfig(rollout_len=8, ppo_epochs=2,
                 share_policy=False), num_envs=8, device="cpu")
    g = torch.Generator()
    ts, es, obs = algo.init(g)
    kernels = [v for k, v in _leaves(_params_tree(ts)["actor"]).items() if "kernel" in k]
    assert kernels and all(k.shape[0] == 3 for k in kernels)
    ts, es, obs, m = algo.train_step(ts, es, obs, g)
    assert np.isfinite(float(m["v_loss"]))
    assert algo.act(ts, obs).shape == (8, 3, 2)


def test_mappo_discrete_categorical_head():
    """JAX ``test_mappo_discrete_categorical_head``: one-hot actions, finite
    losses, a value loss that falls over 6 iterations."""
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True),
                 MAPPOConfig(rollout_len=16, ppo_epochs=4, lr=1e-3), num_envs=16, device="cpu")
    assert algo.discrete
    g = torch.Generator()
    g.manual_seed(0)
    ts, es, obs = algo.init(g)
    losses = []
    for _ in range(6):
        ts, es, obs, m = algo.train_step(ts, es, obs, g)
        assert np.isfinite(float(m["pg_loss"])) and np.isfinite(float(m["entropy"]))
        losses.append(float(m["v_loss"]))
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    for a in (algo.act(ts, obs), algo.act(ts, obs, g, deterministic=False)):
        assert a.shape == (16, 3, 5)
        assert torch.equal(a.sum(-1), torch.ones(16, 3)) and set(a.unique().tolist()) == {0.0, 1.0}


def test_mappo_discrete_separated_policy():
    """JAX ``test_mappo_discrete_separated_policy``."""
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True),
                 MAPPOConfig(rollout_len=8, ppo_epochs=2, share_policy=False), num_envs=8, device="cpu")
    g = torch.Generator()
    ts, es, obs = algo.init(g)
    ts, es, obs, m = algo.train_step(ts, es, obs, g)
    assert np.isfinite(float(m["pg_loss"]))
    a = algo.act(ts, obs)
    assert a.shape == (8, 3, 5) and torch.equal(a.sum(-1), torch.ones(8, 3))


@pytest.mark.parametrize("kind", ["discrete", "separated"])
def test_checkpoint_round_trip(kind, tmp_path):
    """The per-agent and categorical networks go through checkpoint_tree
    and restore_tree, and the next iteration equals the uninterrupted one."""
    from gym_formation_tpu_torch.utils import restore_checkpoint, save_checkpoint

    discrete, share = KINDS[kind]
    cfg = MAPPOConfig(rollout_len=4, ppo_epochs=2, num_minibatches=2, share_policy=share)
    make = lambda: MAPPO(gt.make_env("formation_hd_env", num_agents=3, discrete_action=discrete,
                                     episode_length=6), cfg, num_envs=8, device="cpu")
    algo, g = make(), torch.Generator()
    g.manual_seed(3)
    ts, es, obs = algo.init(g)
    ts, es, obs, _ = algo.train_step(ts, es, obs, g)
    save_checkpoint(str(tmp_path), 1, algo.checkpoint_tree(ts, es, obs, g))
    ts, es, obs, m = algo.train_step(ts, es, obs, g)
    algo2, g2 = make(), torch.Generator()
    ts2, es2, obs2 = algo2.restore_tree(restore_checkpoint(str(tmp_path)), g2)
    ts2, es2, obs2, m2 = algo2.train_step(ts2, es2, obs2, g2)
    for a, b in zip(ts.params(), ts2.params()):
        assert torch.equal(a, b)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m2.items()}
