"""The port's RMAPPO against the JAX package's, in float64 on the same
parameters and numpy batches:

- ``_loss`` on a chunked batch, every gradient leaf (1e-10), and
  ``_update_recurrent`` with JAX's permutations passed in (1e-9);
- the chunk and init layout;
- ``_collect_recurrent`` replayed step by step through JAX's ``env.step``
  and ``GRUPolicy``/``GRUCritic`` on the port's sampled actions, across an
  episode end (carries, values, logp, rewards, reset flags; 1e-9);
- the JAX package's RMAPPO behaviour tests, ported, and a checkpoint
  round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import RMAPPO as JRMAPPO, RMAPPOConfig as JRMAPPOConfig
from gym_formation_tpu.algos.mappo import ValueNorm as JValueNorm
from gym_formation_tpu.core.types import EnvState as JEnvState

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import RMAPPO, RMAPPOConfig, RunnerCarry
from gym_formation_tpu_torch.models.networks import to_flax, to_flax_tree
from gym_formation_tpu_torch.utils import restore_checkpoint, save_checkpoint

F64 = torch.float64
H = 16  # gru_hidden of the parity tests


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


def _setup(discrete, B=8, ep=100, **cfg_kw):
    kw = dict(gru_hidden=H, **cfg_kw)
    jenv = ft.FormationEnv(ft.make_scenario("formation_hd_env", num_agents=3, episode_length=ep),
                           discrete_action=discrete)
    jalgo = JRMAPPO(jenv, JRMAPPOConfig(**kw), num_envs=B)
    ts_j, _, _, _ = jalgo.init(jax.random.PRNGKey(0))
    p64 = _f64(ts_j.params)
    # head gains up, so that the distributions are far from their init
    p64["actor"]["params"]["Dense_1"]["kernel"] = p64["actor"]["params"]["Dense_1"]["kernel"] * 100.0
    tenv = gt.make_env("formation_hd_env", num_agents=3, discrete_action=discrete, episode_length=ep)
    talgo = RMAPPO(tenv, RMAPPOConfig(**kw), num_envs=B, device="cpu", dtype=F64)
    return jalgo, ts_j, p64, talgo


def _unroll(jalgo, params, obs, reset, h_a, h_c):
    """JAX's networks over [L, m, ...] steps from the carries h_a, h_c."""
    dists, values = [], []
    for l in range(obs.shape[0]):
        reset_n = jnp.broadcast_to(reset[l][:, None], obs.shape[1:3])
        h_a, dist = jalgo.actor.apply(params["actor"], h_a, obs[l], reset_n)
        h_c, value = jalgo.critic.apply(params["critic"], h_c, obs[l].reshape(obs.shape[1], -1), reset[l])
        dists.append(dist)
        values.append(value)
    return jax.tree.map(lambda *x: jnp.stack(x), *dists), jnp.stack(values)


def _sequence(jalgo, params, L, m, seed):
    """A batch of m sequences of L steps with the behaviour policy's
    actions (drawn with numpy), jittered logp, resets inside the
    sequences, and nonzero initial carries."""
    rng = np.random.RandomState(seed)
    n, do = jalgo.n_agents, jalgo.obs_dim
    obs = jnp.asarray(rng.uniform(-1.5, 1.5, (L, m, n, do)))
    reset = jnp.asarray(rng.uniform(size=(L, m)) < 0.25)
    h_a, h_c = jnp.asarray(rng.normal(size=(m, n, H)) * 0.5), jnp.asarray(rng.normal(size=(m, H)) * 0.5)
    dist, value = _unroll(jalgo, params, obs, reset, h_a, h_c)
    if jalgo.discrete:
        gumbel = -np.log(-np.log(rng.uniform(size=dist.shape)))
        action = jnp.asarray(np.eye(dist.shape[-1])[np.argmax(np.asarray(dist) + gumbel, -1)])
    else:
        action = dist[0] + jnp.exp(dist[1]) * rng.normal(size=dist[0].shape)
    logp = jalgo._dist_logp(dist, action) + 0.2 * rng.normal(size=(L, m, n))
    return dict(obs=obs, reset=reset, action=action, logp=logp, value=value,
                target=value + rng.normal(size=value.shape), adv=jnp.asarray(rng.normal(size=(L, m)))), h_a, h_c


def _torch(batch):
    return {k: torch.as_tensor(np.array(v), dtype=torch.bool if k == "reset" else F64) for k, v in batch.items()}


@pytest.mark.parametrize("discrete", [False, True])
def test_loss_and_grads_match_jax(discrete):
    jalgo, _, p64, talgo = _setup(discrete)
    seq, h_a, h_c = _sequence(jalgo, p64, 5, 12, 1)
    batch = dict(seq, h_actor0=h_a, h_critic0=h_c)
    (total_j, met_j), g_j = jax.value_and_grad(jalgo._loss, has_aux=True)(p64, batch, JValueNorm.create())
    ts = talgo.state_from_flax(_np(p64))
    _assert_trees(_params_tree(ts), p64, 0, 0)
    total_t, met_t = talgo._loss(ts, _torch(batch), ts.value_norm)
    grads = torch.autograd.grad(total_t, ts.params())
    np.testing.assert_allclose(float(total_t.detach()), float(total_j), rtol=1e-10, atol=1e-10)
    assert sorted(met_t) == sorted(met_j)
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k].detach()), float(met_j[k]), rtol=1e-10, atol=1e-10, err_msg=k)
    na = len(list(ts.actor.parameters()))
    names = lambda m: [k for k, _ in m.named_parameters()]
    g_t = {"actor": to_flax_tree(dict(zip(names(ts.actor), grads[:na]))),
           "critic": to_flax_tree(dict(zip(names(ts.critic), grads[na:])))}
    _assert_trees(g_t, g_j, 1e-10, 1e-10)


def _trajectory(jalgo, params, T, B, seed):
    """A [T, B] trajectory in the collection's layout, with the carries the
    networks had before each step."""
    seq, h_a, h_c = _sequence(jalgo, params, T, B, seed)
    ha, hc = [], []
    for t in range(T):
        ha.append(h_a)
        hc.append(h_c)
        reset_n = jnp.broadcast_to(seq["reset"][t][:, None], seq["obs"].shape[1:3])
        h_a, _ = jalgo.actor.apply(params["actor"], h_a, seq["obs"][t], reset_n)
        h_c, _ = jalgo.critic.apply(params["critic"], h_c, seq["obs"][t].reshape(B, -1), seq["reset"][t])
    return dict(seq, h_actor=jnp.stack(ha), h_critic=jnp.stack(hc))


@pytest.mark.parametrize("discrete", [False, True])
def test_update_recurrent_matches_jax(discrete):
    """One _update_recurrent of 3 epochs at two minibatches over the K·B
    chunks, JAX's permutations passed in: parameters (1e-9) and metrics."""
    T, B, L = 10, 4, 5
    jalgo, ts_j, p64, talgo = _setup(discrete, B=B, rollout_len=T, data_chunk_length=L, ppo_epochs=3,
                                     num_minibatches=2)
    ts_j = ts_j.replace(params=p64, opt_state=jalgo.tx.init(p64), value_norm=JValueNorm.create())
    data = _trajectory(jalgo, p64, T, B, 3)
    key = jax.random.PRNGKey(4)
    ts_j2, m_j = jalgo._update_recurrent(ts_j, data, key)
    M = (T // L) * B
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, M))) for k in jax.random.split(key, 3)]
    ts = talgo.state_from_flax(_np(p64))
    ts, m_t = talgo._update_recurrent(ts, _torch(data), None, perms=perms)
    _assert_trees(_params_tree(ts), ts_j2.params, 1e-9, 1e-9)
    assert ts.opt_state.count == 6
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-9, atol=1e-9, err_msg=k)


def test_chunk_and_init_layout():
    """[T, B] → [L, K·B]: chunk k of env b at column k·B + b holds steps
    k·L .. k·L + L − 1; its initial carries are the stored ones of step
    k·L.  init gives zero carries and no pending reset."""
    T, B, L = 10, 3, 5
    algo = RMAPPO(gt.make_env("formation_hd_env", num_agents=3),
                  RMAPPOConfig(rollout_len=T, data_chunk_length=L, gru_hidden=4), num_envs=B, device="cpu")
    idx = torch.arange(T * B, dtype=torch.float64).reshape(T, B)
    data = {k: idx for k in ("obs", "action", "logp", "value", "adv", "target", "reset")}
    data["h_actor"] = idx[..., None, None].expand(T, B, 3, 4)
    data["h_critic"] = idx[..., None].expand(T, B, 4)
    c = algo._chunks(data)
    for k in range(T // L):
        for b in range(B):
            for l in range(L):
                assert c["obs"][l, k * B + b] == idx[k * L + l, b]
            assert torch.all(c["h_actor0"][k * B + b] == idx[k * L, b])
            assert torch.all(c["h_critic0"][k * B + b] == idx[k * L, b])
    g = torch.Generator()
    ts, es, obs, carry = algo.init(g)
    assert carry.h_actor.shape == (B, 3, 4) and carry.h_critic.shape == (B, 4)
    assert not carry.done_prev.any() and not carry.h_actor.any() and not carry.h_critic.any()
    assert obs.shape == (B, 3, 18)


def _jstate(state):
    st = gt.state_to_numpy(state)
    keys = jax.random.split(jax.random.PRNGKey(0), st["pos"].shape[0])
    return JEnvState(**{k: jnp.asarray(v) for k, v in st.items()}, key=keys)


@pytest.mark.parametrize("discrete", [False, True])
def test_collect_recurrent_replays_in_jax(discrete):
    """T=8 steps with episodes of 5 (every env ends one at step 4 and
    resets its carries at step 5), from nonzero carries: JAX's env.step on
    the port's pre-step states and sampled actions, and JAX's GRU networks
    on the port's stored observations and reset flags, give the stored
    carries, values, logp, rewards and done flags (1e-9)."""
    T, B, n = 8, 6, 3
    jalgo, _, p64, talgo = _setup(discrete, B=B, ep=5, rollout_len=T, data_chunk_length=4)
    ts = talgo.state_from_flax(_np(p64))
    venv = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, device="cpu", seed=2, episode_length=5)
    state, _ = venv.reset()
    state = gt.state_from_numpy(gt.state_to_numpy(state), dtype=F64)
    state = state.replace(t=torch.arange(B, dtype=torch.int32) % 3)  # episodes end at steps 2-4
    obs = talgo.env.scenario.observe(state)
    rng = np.random.RandomState(5)
    carry = RunnerCarry(h_actor=torch.as_tensor(rng.normal(size=(B, n, H))),
                        h_critic=torch.as_tensor(rng.normal(size=(B, H))),
                        done_prev=torch.tensor([True, False, False, True, False, False]))
    pre_states, step = [], talgo.env.step

    def recording_step(st, actions, generator):
        pre_states.append(st)
        return step(st, actions, generator)

    talgo.env.step = recording_step
    g = torch.Generator()
    g.manual_seed(7)
    with torch.no_grad():
        _, obs_out, carry_out, traj, _, last_value = talgo._collect_recurrent(ts, state, obs, carry, g)
    assert len(pre_states) == T

    done = traj["done"].numpy()
    assert done.any(0).all()  # every env ended an episode
    reset = traj["reset"].numpy()
    np.testing.assert_array_equal(reset[0], carry.done_prev.numpy())
    np.testing.assert_array_equal(reset[1:], done[:-1])
    np.testing.assert_array_equal(carry_out.done_prev.numpy(), done[-1])

    jenv = jalgo.env
    h_a, h_c = jnp.asarray(carry.h_actor.numpy()), jnp.asarray(carry.h_critic.numpy())
    for t in range(T):
        np.testing.assert_allclose(traj["h_actor"][t].numpy(), np.asarray(h_a), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(traj["h_critic"][t].numpy(), np.asarray(h_c), rtol=1e-9, atol=1e-9)
        o, r = jnp.asarray(traj["obs"][t].numpy()), jnp.asarray(reset[t])
        h_a, dist = jalgo.actor.apply(p64["actor"], h_a, o, jnp.broadcast_to(r[:, None], (B, n)))
        h_c, value = jalgo.critic.apply(p64["critic"], h_c, o.reshape(B, -1), r)
        np.testing.assert_allclose(traj["value"][t].numpy(), np.asarray(value), rtol=1e-9, atol=1e-9)
        action = jnp.asarray(traj["action"][t].numpy())
        np.testing.assert_allclose(traj["logp"][t].numpy(), np.asarray(jalgo._dist_logp(dist, action)),
                                   rtol=1e-9, atol=1e-9)
        if discrete:
            assert torch.equal(traj["action"][t].sum(-1), torch.ones(B, n, dtype=F64))
        _, out = jax.vmap(jenv.step)(_jstate(pre_states[t]), action)
        np.testing.assert_allclose(traj["reward"][t].numpy(), np.asarray(out.reward[:, 0]), rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(done[t], np.asarray(out.done[:, 0]))
    np.testing.assert_allclose(carry_out.h_actor.numpy(), np.asarray(h_a), rtol=1e-9, atol=1e-9)
    _, v_last = jalgo.critic.apply(p64["critic"], h_c, jnp.asarray(obs_out.numpy()).reshape(B, -1),
                                   jnp.asarray(done[-1]))
    np.testing.assert_allclose(last_value.numpy(), np.asarray(v_last), rtol=1e-9, atol=1e-9)


def test_rmappo_runs_and_resets_hidden():
    """JAX ``test_rmappo_runs_and_resets_hidden``."""
    algo = RMAPPO(gt.make_env("formation_hd_env", num_agents=3, episode_length=5),
                  RMAPPOConfig(rollout_len=10, data_chunk_length=5, ppo_epochs=2, num_minibatches=1),
                  num_envs=8, device="cpu")
    g = torch.Generator()
    ts, es, obs, carry = algo.init(g)
    p0 = next(ts.actor.parameters()).detach().clone()
    for _ in range(3):
        ts, es, obs, carry, m = algo.train_step(ts, es, obs, carry, g)
    assert np.isfinite(float(m["v_loss"]))
    assert not torch.allclose(next(ts.actor.parameters()), p0)
    assert carry.h_actor.shape == (8, 3, 64)
    a, carry2 = algo.act(ts, obs, carry)
    assert a.shape == (8, 3, 2) and not carry2.done_prev.any()


def test_rmappo_discrete_recurrent_categorical():
    """JAX ``test_rmappo_discrete_recurrent_categorical``."""
    algo = RMAPPO(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True),
                  RMAPPOConfig(rollout_len=10, data_chunk_length=5, ppo_epochs=2), num_envs=8, device="cpu")
    assert algo.discrete
    g = torch.Generator()
    ts, es, obs, carry = algo.init(g)
    assert ts.actor.discrete
    for _ in range(2):
        ts, es, obs, carry, m = algo.train_step(ts, es, obs, carry, g)
    assert np.isfinite(float(m["pg_loss"])) and np.isfinite(float(m["entropy"]))
    a, carry = algo.act(ts, obs, carry)
    assert a.shape == (8, 3, 5)
    assert torch.equal(a.sum(-1), torch.ones(8, 3)) and set(a.unique().tolist()) == {0.0, 1.0}


def test_rmappo_learning_signal():
    """The rmappo case of JAX's ``test_recurrent_learning_signal``: the
    per-step training reward trends up over a miniature run (30
    iterations, episodes of 8 steps, 16 envs)."""
    algo = RMAPPO(gt.make_env("formation_hd_env", num_agents=3, episode_length=8),
                  RMAPPOConfig(rollout_len=16, data_chunk_length=4, ppo_epochs=4, lr=1e-3), num_envs=16,
                  device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    state = algo.init(g)
    rews = []
    for _ in range(30):
        *state, m = algo.train_step(*state, g)
        rews.append(float(m["mean_step_reward"]))
    assert np.isfinite(rews).all()
    assert np.mean(rews[-5:]) > np.mean(rews[:5]) + 0.1, rews


def test_checkpoint_round_trip(tmp_path):
    """Save after 2 iterations (the RunnerCarry included), restore into
    fresh objects, and the third iteration equals the uninterrupted run's
    bit for bit."""
    cfg = RMAPPOConfig(rollout_len=4, data_chunk_length=2, ppo_epochs=2, num_minibatches=2, gru_hidden=8)

    def make():
        return RMAPPO(gt.make_env("formation_hd_env", num_agents=3, episode_length=3), cfg, num_envs=4,
                      device="cpu")

    algo, g = make(), torch.Generator()
    g.manual_seed(3)
    state = algo.init(g)
    for _ in range(2):
        *state, _ = algo.train_step(*state, g)
    save_checkpoint(str(tmp_path), 2, algo.checkpoint_tree(*state, g))
    *state, m = algo.train_step(*state, g)
    algo2, g2 = make(), torch.Generator()
    state2 = algo2.restore_tree(restore_checkpoint(str(tmp_path)), g2)
    assert state2[0].update_i == 2 and isinstance(state2[3], RunnerCarry)
    *state2, m2 = algo2.train_step(*state2, g2)
    for a, b in zip(state[0].params(), state2[0].params()):
        assert torch.equal(a, b)
    for k in ("h_actor", "h_critic", "done_prev"):
        assert torch.equal(getattr(state[3], k), getattr(state2[3], k))
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m2.items()}


def test_unused_config_raises():
    env = gt.make_env("formation_hd_env", num_agents=3)
    for kw in (dict(share_policy=False), dict(auto_entropy=True), dict(grad_accum=2), dict(remat=True)):
        with pytest.raises(ValueError, match="RMAPPO does not take"):
            RMAPPO(env, RMAPPOConfig(**kw), num_envs=4, device="cpu")
    with pytest.raises(ValueError, match="multiple of data_chunk_length"):
        RMAPPO(env, RMAPPOConfig(rollout_len=7), num_envs=4, device="cpu")
