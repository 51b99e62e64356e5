"""The obs-free first layers (``models/structured_obs.py``) against the JAX
package's in float64, the structured forwards against the obs-based
networks, one structured ``_update`` against JAX, the bf16 forward's error
against the JAX bf16 forward's, and the structured collection never
building an observation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MAPPO as JMAPPO, MAPPOConfig as JMAPPOConfig
from gym_formation_tpu.algos.mappo import ValueNorm as JValueNorm
from gym_formation_tpu.models import structured_obs as jso
from gym_formation_tpu.models.networks import gaussian_logp as jgaussian_logp

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig
from gym_formation_tpu_torch.envs.formation_hd import FormationHDScenario
from gym_formation_tpu_torch.models import structured_obs as tso
from gym_formation_tpu_torch.models.networks import GaussianActor, ValueCritic, to_flax

F64 = torch.float64


def _parts(N, B, seed):
    rng = np.random.RandomState(seed)
    ish = rng.uniform(-1, 1, (B, N, 2))
    return (rng.uniform(-1, 1, (B, N, 2)), rng.uniform(-0.5, 0.5, (B, N, 2)),
            ish - ish.mean(1, keepdims=True), rng.uniform(-1, 1, (B, 2)))


@pytest.mark.parametrize("N", [7, 32])
def test_first_layers_match_jax(N):
    """hd_actor_h1 (the port's prefix by cumulative sum, JAX's by the
    triangle product) and hd_critic_h1, float64, 1e-10."""
    rng = np.random.RandomState(N)
    W, b = rng.normal(size=(6 * N, 64)) * 0.3, rng.normal(size=64)
    Wc, bc = rng.normal(size=(6 * N * N, 64)) * 0.1, rng.normal(size=64)
    parts = _parts(N, 3, N + 1)
    jp, tp = [jnp.asarray(p) for p in parts], [torch.as_tensor(p) for p in parts]
    t = lambda a: torch.as_tensor(a)
    np.testing.assert_allclose(tso.hd_actor_h1(t(W), t(b), *tp).numpy(),
                               np.asarray(jso.hd_actor_h1(jnp.asarray(W), jnp.asarray(b), *jp)),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tso.hd_critic_h1(t(Wc), t(bc), *tp).numpy(),
                               np.asarray(jso.hd_critic_h1(jnp.asarray(Wc), jnp.asarray(bc), *jp)),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("N", [7, 32])
def test_structured_forwards_match_obs_networks(N):
    """actor_/critic_forward_structured from the state parts equal the
    networks on the observation the env builds from the same state."""
    g = torch.Generator()
    g.manual_seed(N)
    actor = GaussianActor(6 * N, 2, generator=g).to(F64)
    critic = ValueCritic(6 * N * N, generator=g).to(F64)
    apos, avel, ish, ivel = _parts(N, 4, N)
    scen = FormationHDScenario(num_agents=N, dtype=F64)
    state = gt.state_from_numpy(dict(
        pos=np.concatenate([apos, ish + apos.mean(1, keepdims=True)], 1),
        vel=np.concatenate([avel, np.zeros_like(avel)], 1), c=np.zeros((4, N, 2)),
        ideal_shape=ish, ideal_vel=ivel, t=np.zeros(4, np.int32)), dtype=F64)
    obs = scen.observe(state)
    tp = [torch.as_tensor(p) for p in (apos, avel, ish, ivel)]
    with torch.no_grad():
        mean, ls = actor(obs)
        smean, sls = tso.actor_forward_structured(actor, *tp)
        v, sv = critic(obs.reshape(4, -1)), tso.critic_forward_structured(critic, *tp)
    for got, want in ((smean, mean), (sls, ls), (sv, v)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-10)


def test_structured_update_matches_jax():
    """One structured _update (2 epochs, N=32) from the same float64
    parameters and state-parts batch: the parameters after it to atol 1e-8,
    rtol 1e-7.  Looser than the obs path's 1e-9: the two first layers sum
    the prefix in different orders (cumulative sum against triangle
    product), and Adam's normalized first steps carry that float64
    reassociation (about 1e-16 relative) up to about 1e-9 on the smallest
    gradient components."""
    N, T, B = 32, 2, 4
    M = T * B
    jenv = ft.make_env("formation_hd_env", num_agents=N)
    jalgo = JMAPPO(jenv, JMAPPOConfig(rollout_len=T, ppo_epochs=2), num_envs=B)
    assert jalgo.structured_obs
    ts_j, _, _ = jalgo.init(jax.random.PRNGKey(0))
    p64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), ts_j.params)
    ts_j = ts_j.replace(params=p64, opt_state=jalgo.tx.init(p64), value_norm=JValueNorm.create())
    rng = np.random.RandomState(5)
    apos, avel, ish, ivel = (jnp.asarray(p) for p in _parts(N, M, 6))
    (mean, ls), value = jalgo._structured_dist_value(p64, dict(apos=apos, avel=avel, ishape=ish, ivel=ivel))
    action = mean + jnp.exp(ls) * rng.normal(size=mean.shape)
    data = dict(apos=apos, avel=avel, ishape=ish, ivel=ivel, action=action,
                logp=jgaussian_logp(mean, ls, action) + 0.2 * rng.normal(size=(M, N)),
                value=value, target=value + rng.normal(size=M), adv=jnp.asarray(rng.normal(size=M)))
    ts_j2, m_j = jalgo._update(ts_j, data, jax.random.PRNGKey(1))

    talgo = MAPPO(gt.make_env("formation_hd_env", num_agents=N), MAPPOConfig(rollout_len=T, ppo_epochs=2),
                  num_envs=B, device="cpu", dtype=F64)
    assert talgo.structured_obs
    ts = talgo.state_from_flax(jax.tree.map(np.asarray, p64))
    ts, m_t = talgo._update(ts, {k: torch.as_tensor(np.array(v)) for k, v in data.items()})
    for got, want in ((to_flax(ts.actor), ts_j2.params["actor"]),
                      (to_flax(ts.critic), ts_j2.params["critic"])):
        for (path, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                     jax.tree_util.tree_flatten_with_path(want)[0]):
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-7, atol=1e-8, err_msg=jax.tree_util.keystr(path))
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-9, atol=1e-9, err_msg=k)


def test_bf16_forward_within_twice_jax_bf16_error():
    """structured_bf16: the port's bf16 actor forward is off the JAX float32
    forward by at most twice what the JAX bf16 forward is, and returns the
    distribution parameters in float32."""
    N = 32
    env = ft.make_env("formation_hd_env", num_agents=N)
    state, _ = jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(7), 4))
    jparts = (state.pos[:, :N], state.vel[:, :N] + 0.1, state.ideal_shape, state.ideal_vel)
    jparts = tuple(jnp.asarray(p, jnp.float32) for p in jparts)
    from gym_formation_tpu.models.networks import GaussianActor as JActor

    pa = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                      JActor(2, (64, 64)).init(jax.random.PRNGKey(1), jnp.zeros((1, 6 * N), jnp.float32)))
    m32, _ = jso.actor_forward_structured(pa, *jparts, (64, 64))
    m16, _ = jso.actor_forward_structured(pa, *jparts, (64, 64), dtype=jnp.bfloat16)
    from gym_formation_tpu_torch.models.networks import actor_from_flax

    actor = actor_from_flax(jax.tree.map(np.asarray, pa))
    tparts = [torch.as_tensor(np.array(p)) for p in jparts]
    with torch.no_grad():
        t16, tls = tso.actor_forward_structured(actor, *tparts, dtype=torch.bfloat16)
    assert t16.dtype == torch.float32 and tls.dtype == torch.float32
    err_jax = float(np.abs(np.asarray(m16) - np.asarray(m32)).max())
    err_port = float(np.abs(t16.numpy() - np.asarray(m32)).max())
    assert 0 < err_jax and err_port <= 2 * err_jax, (err_port, err_jax)


def test_structured_collection_builds_no_observation(monkeypatch):
    """At N >= 32 the auto gate takes the structured path; init returns no
    observation and train_step never calls observe."""
    env = gt.make_env("formation_hd_env", num_agents=32)
    algo = MAPPO(env, MAPPOConfig(rollout_len=3, ppo_epochs=2), num_envs=4, device="cpu")
    assert algo.structured_obs and not algo.fused_collect
    calls = []
    observe = env.scenario.observe
    monkeypatch.setattr(env.scenario, "observe", lambda s: calls.append(1) or observe(s))
    g = torch.Generator()
    g.manual_seed(0)
    ts, es, obs = algo.init(g)
    assert obs is None
    for _ in range(2):
        ts, es, obs, m = algo.train_step(ts, es, obs, g)
        assert all(np.isfinite(float(v)) for v in m.values())
    assert calls == [] and obs is None
    bf = MAPPO(env, MAPPOConfig(rollout_len=3, ppo_epochs=2, structured_bf16=True), num_envs=4, device="cpu")
    _, _, _, m = bf.train_step(ts, es, obs, g)
    assert all(np.isfinite(float(v)) for v in m.values())
