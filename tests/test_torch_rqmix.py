"""The port's recurrent QMIX and VDN against the JAX package's, in float64
on the same parameters, episodes and draws: ``RecurrentQNet`` round-trips
exactly through the port's ``GRUPolicy`` (logits head), one ``_q_step`` and
the Q rollouts (1e-10); ``_loss`` and every gradient leaf of the Q network
and the mixer (1e-10) and three ``_update_once`` calls (1e-9), for RQMIX,
RVDN and RQMIX without double Q; the ε-greedy collection against JAX's (its
draws from ``fold_in(k, 0|1)`` of each step's key); the loss blind to the
episodes' last observation; the JAX package's
``test_recurrent_qmix_vdn_run``, ported; a checkpoint round trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_formation_tpu.algos import RQMix as JRQMix, RQMixConfig as JRQMixConfig
from gym_formation_tpu.algos.rqmix import RecurrentQNet, RQMixState as JRQMixState

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import RQMix, RQMixConfig
from gym_formation_tpu_torch.models.networks import GRUPolicy, gru_policy_from_flax
from _offpolicy import (  # noqa: F401 (one_torch_thread: a module fixture)
    EP_T, F64, assert_ignores_terminal_obs, assert_module, assert_round_trip, assert_trees, checkpoint_round_trip,
    episodes, f64, grads_tree, jenv_f64, np_tree, one_torch_thread, per_step, perturbed, replay_episodes,
    scaled_head, step_keys, t,
)

TOL = dict(rtol=1e-10, atol=1e-10)
CASES = {"rqmix": dict(mixer="qmix"), "rvdn": dict(mixer="vdn"), "rqmix_single_q": dict(mixer="qmix", double_q=False)}
SMALL = dict(gru_hidden=16, mixer_embed=8, buffer_episodes=16)


@functools.lru_cache(maxsize=None)
def _jax(B, kw):
    jalgo = JRQMix(jenv_f64(discrete=True), JRQMixConfig(**dict(kw)), num_envs=B)
    ts0 = jax.jit(lambda k: jalgo.init(k)[0])(jax.random.PRNGKey(0))
    q, m = f64(ts0.q_params), f64(ts0.mixer_params)
    q = scaled_head(q, head="Dense_1", by=100.0)
    tq, tm = perturbed(q, 1), perturbed(m, 2)
    ts_j = JRQMixState(q_params=q, mixer_params=m, target_q_params=tq, target_mixer_params=tm,
                       opt_state=jalgo.tx.init({"q": q, "mixer": m}), env_steps=jnp.zeros((), jnp.int32),
                       grad_updates=jnp.zeros((), jnp.int32))
    return jalgo, ts_j, np_tree({"q": q, "mixer": m, "target_q": tq, "target_mixer": tm})


def _pair(B=4, **cfg_kw):
    kw = dict(SMALL, **cfg_kw)
    jalgo, ts_j, params = _jax(B, tuple(sorted(kw.items())))
    talgo = RQMix(gt.make_env("formation_hd_env", num_agents=3, episode_length=EP_T, discrete_action=True),
                  RQMixConfig(**kw), num_envs=B, device="cpu", dtype=F64)
    return jalgo, ts_j, talgo, talgo.state_from_flax(params)


def _b(seed, M):
    return episodes(seed, M, EP_T, 3, 18, 5, True)


def test_recurrent_q_net_round_trip():
    """``RecurrentQNet`` (``Dense_0 → GRUCell_0 → Dense_1`` over obs ⊕ id) is
    ``GRUPolicy(obs_dim + N, 5, H, discrete=True)``'s tree, exactly."""
    inputs = (jnp.zeros((1, 3, 16)), jnp.zeros((1, 3, 21)), jnp.zeros((1, 3), bool))
    assert_round_trip(RecurrentQNet(5, 16), inputs, gru_policy_from_flax, stacked=False)
    assert type(gru_policy_from_flax(np_tree(_jax(4, tuple(sorted(SMALL.items())))[1].q_params))) is GRUPolicy


def test_q_step_and_rollout_match_jax():
    B = 5
    jalgo, ts_j, talgo, ts = _pair()
    rng = np.random.RandomState(0)
    carry, obs = rng.normal(size=(B, 3, 16)), rng.uniform(-1.5, 1.5, (B, 3, 18))
    reset = np.array([True, False, True, False, False])
    h_j, q_j = jax.jit(jalgo._q_step)(ts_j.q_params, jnp.asarray(carry), jnp.asarray(obs), jnp.asarray(reset))
    with torch.no_grad():
        h_t, q_t = talgo._q_step(ts.q, t(carry), t(obs), torch.as_tensor(reset))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), **TOL)
    seq = rng.uniform(-1.5, 1.5, (B, EP_T + 1, 3, 18))
    with torch.no_grad():
        got = talgo._q_rollout(ts.q, t(seq))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jalgo._q_rollout)(ts_j.q_params, jnp.asarray(seq))),
                               **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case):
    jalgo, ts_j, talgo, ts = _pair(**CASES[case])
    b = _b(1, 6)
    params = {"q": ts_j.q_params, "mixer": ts_j.mixer_params}
    (loss_j, aux_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jalgo._loss(p, ts_j, {k: jnp.asarray(v) for k, v in b.items()}), has_aux=True))(params)
    loss, aux = talgo._loss(ts, {k: t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    np.testing.assert_allclose(float(aux["q_tot"].detach()), float(aux_j["q_tot"]), **TOL)
    grads = torch.autograd.grad(loss, talgo._params(ts.q, ts.mixer))
    nq = len(list(ts.q.parameters()))
    want = {"q": grads_tree(ts.q, grads[:nq])}
    want["mixer"] = grads_tree(ts.mixer, grads[nq:]) if ts.mixer is not None else {}
    assert_trees(want, g_j, 1e-10, 1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_update_once_matches_jax(case):
    """Three updates (the global-norm clip at 10 included): Q network,
    mixer, both soft targets and the metrics (1e-9)."""
    jalgo, ts_j, talgo, ts = _pair(**CASES[case])
    update = jax.jit(jalgo._update_once)
    for k in range(3):
        b = _b(10 + k, 5)
        ts_j, aux_j = update(ts_j, {k2: jnp.asarray(v) for k2, v in b.items()})
        aux_t = talgo._update_once(ts, {k2: t(v) for k2, v in b.items()})
        for name in aux_j:
            np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]), rtol=1e-9, atol=1e-9, err_msg=name)
    assert_module(ts.q, ts_j.q_params)
    assert_module(ts.target_q, ts_j.target_q_params)
    if ts.mixer is not None:
        assert_module(ts.mixer, ts_j.mixer_params)
        assert_module(ts.target_mixer, ts_j.target_mixer_params)
    assert ts.grad_updates == int(ts_j.grad_updates) == 3


def test_collection_matches_jax():
    """ε-greedy episodes at ε about 0.5 (both branches taken): the random
    actions from ``randint(fold_in(k, 0))`` and the coin from
    ``uniform(fold_in(k, 1))`` of each step's key, one-hots."""
    jalgo, ts_j, talgo, ts = _pair()
    B, steps = jalgo.num_envs, 25_000
    ts_j, ts.env_steps = ts_j.replace(env_steps=jnp.asarray(steps, jnp.int32)), steps
    eps = talgo.epsilon(ts)
    # JAX's ε is float32 even under x64; the port's a Python float
    np.testing.assert_allclose(eps, float(jalgo.epsilon(ts_j)), rtol=1e-7)
    assert jalgo.epsilon(ts_j).dtype == jnp.float32

    def draws(k_roll):
        keys = step_keys(k_roll, EP_T)
        return {"rand": per_step(keys, lambda k: jax.random.randint(jax.random.fold_in(k, 0), (B, 3), 0, 5)).long(),
                "uniform": per_step(keys, lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (B, 3)))}

    _, act, _ = replay_episodes(jalgo, ts_j, talgo, ts, jax.random.PRNGKey(3), draws)
    assert torch.equal(act.sum(-1), torch.ones(act.shape[:3], dtype=F64)) and set(act.unique().tolist()) == {0.0, 1.0}
    coin = draws(jax.random.split(jax.random.PRNGKey(3))[1])["uniform"]
    assert (coin < eps).any() and (coin >= eps).any()


def test_loss_ignores_terminal_obs():
    """The last step's bootstrap is masked: the loss and every gradient are
    the same bits whatever ``obs[:, T]`` holds (double Q's pick there
    included)."""
    _, _, talgo, ts = _pair()

    def losses(batch):
        loss, _ = talgo._loss(ts, batch)
        return [loss.detach(), *torch.autograd.grad(loss, talgo._params(ts.q, ts.mixer))]

    assert_ignores_terminal_obs(losses, _b(4, 5))


@pytest.mark.parametrize("mixer", ["qmix", "vdn"])
def test_recurrent_qmix_vdn_run(mixer):
    """JAX ``test_recurrent_qmix_vdn_run``."""
    env = gt.make_env("formation_hd_env", num_agents=3, episode_length=8, discrete_action=True)
    algo = RQMix(env, RQMixConfig(mixer=mixer, buffer_episodes=64, batch_episodes=4, episodes_per_iter=2,
                                  updates_per_iter=2, eps_anneal_steps=200), num_envs=4, device="cpu")
    g = torch.Generator()
    ts, buf = algo.init(g)
    for _ in range(3):
        ts, buf, m = algo.train_step(ts, buf, g)
    assert np.isfinite(float(m["q_loss"])) and float(m["q_loss"]) > 0
    assert float(m["epsilon"]) < 1.0
    a = buf.action[:buf.size]
    assert torch.equal(a.sum(-1), torch.ones(a.shape[:3]))


def test_requires_a_discrete_env():
    with pytest.raises(ValueError, match="discrete_action"):
        RQMix(gt.make_env("formation_hd_env", num_agents=3), device="cpu")
    with pytest.raises(ValueError, match="unknown mixer"):
        RQMix(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True), RQMixConfig(mixer="sum"),
              device="cpu")


def test_checkpoint_round_trip(tmp_path):
    """RQMIX: the whole tuple, the mixer and its targets included."""
    def make():
        return RQMix(gt.make_env("formation_hd_env", num_agents=3, episode_length=3, discrete_action=True),
                     RQMixConfig(buffer_episodes=12, batch_episodes=4, episodes_per_iter=2, updates_per_iter=2,
                                 gru_hidden=8, mixer_embed=4), num_envs=3, device="cpu")

    algo, state = checkpoint_round_trip(make, tmp_path)
    assert state[0].opt.count == 6
