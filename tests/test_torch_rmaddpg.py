"""The port's RMADDPG and RMATD3 and their episode buffer against the JAX
package's, in float64 on the same parameters, episodes and draws:

- the stacked GRU actor's converter round trip, one ``_actor_step`` with
  resets and whole-episode rollouts (1e-10);
- ``_losses`` and every gradient leaf (1e-10; RMATD3's smoothing noise from
  JAX's key), with ``mask_done`` on and off, and three ``_update_once``
  calls (1e-9);
- the collection against JAX's from the same reset states and draws
  (``split(k_roll, T)``), its last observation the true terminal one; the
  default losses blind to that observation;
- the ``EpisodeBuffer`` ring against JAX's, the noise decay, the metric keys
  of ``train_step`` for the five recurrent names;
- the JAX package's behaviour tests (``test_rmaddpg_and_rmatd3_run``,
  ``test_recurrent_learning_signal``), ported, and a checkpoint round trip.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import RMADDPG as JRMADDPG, RMADDPGConfig as JRMADDPGConfig
from gym_formation_tpu.algos import registry as jreg
from gym_formation_tpu.algos.rmaddpg import EpisodeBuffer as JEpisodeBuffer, RMADDPGState as JRMADDPGState
from gym_formation_tpu.models.networks import GRUPolicy as JGRUPolicy

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import RMADDPG, EpisodeBuffer, RMADDPGConfig, make_algo
from gym_formation_tpu_torch.algos.rmaddpg import grads_of
from gym_formation_tpu_torch.models.networks import stacked_gru_policy_from_flax
from _offpolicy import (  # noqa: F401 (one_torch_thread: a module fixture)
    EP_T, F64, assert_ignores_terminal_obs, assert_module, assert_round_trip, assert_trees, checkpoint_round_trip,
    episodes, f64, grads_tree, jenv_f64, jnormal, np_tree, one_torch_thread, per_step, perturbed, replay_episodes,
    scaled_head, step_keys, t,
)

TOL = dict(rtol=1e-10, atol=1e-10)
CASES = {"rmaddpg": dict(), "rmaddpg_no_mask": dict(mask_done=False), "rmatd3": dict(twin=True)}
SMALL = dict(gru_hidden=16, critic_hidden=(16, 16), buffer_episodes=16)


@functools.lru_cache(maxsize=None)
def _jax(B, kw):
    jalgo = JRMADDPG(jenv_f64(), JRMADDPGConfig(**dict(kw)), num_envs=B)
    ts0 = jax.jit(lambda k: jalgo.init(k)[0])(jax.random.PRNGKey(0))
    a, c = f64(ts0.actor_params), f64(ts0.critic_params)
    a = scaled_head(a, head="Dense_1")
    ta, tc = perturbed(a, 1), perturbed(c, 2)
    ts_j = JRMADDPGState(actor_params=a, critic_params=c, target_actor_params=ta, target_critic_params=tc,
                         actor_opt=jalgo.actor_tx.init(a), critic_opt=jalgo.critic_tx.init(c),
                         noise=jnp.asarray(0.3, jnp.float64), env_steps=jnp.zeros((), jnp.int32),
                         grad_updates=jnp.zeros((), jnp.int32))
    return jalgo, ts_j, np_tree({"actor": a, "critic": c, "target_actor": ta, "target_critic": tc})


def _pair(B=4, **cfg_kw):
    """The JAX learner and its state in float64 (the actors' head gains up,
    the targets perturbed away from the online networks, the noise at 0.3),
    and the port's holding the same."""
    kw = dict(SMALL, **cfg_kw)
    jalgo, ts_j, params = _jax(B, tuple(sorted(kw.items())))
    talgo = RMADDPG(gt.make_env("formation_hd_env", num_agents=3, episode_length=EP_T), RMADDPGConfig(**kw),
                    num_envs=B, device="cpu", dtype=F64)
    ts = talgo.state_from_flax(params)
    ts.noise = 0.3
    return jalgo, ts_j, talgo, ts


def draws_of(key, M, twin):
    """RMATD3's smoothing normals as JAX draws them from the update key."""
    return {"target_noise": t(jnormal(key, (M, EP_T, 3, 2)))} if twin else {}


def test_gru_policy_round_trip():
    """RMADDPG's actors, the JAX ``GRUPolicy`` initialised by ``vmap`` over 3
    agents (``log_std`` included), through ``stacked_gru_policy_from_flax``
    and back, exactly: the gate split cuts axis 1 of the stacked leaves."""
    inputs = (jnp.zeros((1, 16)), jnp.zeros((1, 18)), jnp.zeros((1,), bool))
    assert_round_trip(JGRUPolicy(2, 16), inputs, stacked_gru_policy_from_flax)


def test_actor_step_and_rollout_match_jax():
    """One step from a stale carry with some envs resetting, and the
    rollouts over T and T+1 steps (1e-10)."""
    B = 5
    jalgo, ts_j, talgo, ts = _pair()
    rng = np.random.RandomState(0)
    carry, obs = rng.normal(size=(B, 3, 16)), rng.uniform(-1.5, 1.5, (B, 3, 18))
    reset = np.array([True, False, True, False, False])
    h_j, a_j = jax.jit(jalgo._actor_step)(ts_j.actor_params, jnp.asarray(carry), jnp.asarray(obs),
                                          jnp.asarray(reset))
    with torch.no_grad():
        h_t, a_t = talgo._actor_step(ts.actor, t(carry), t(obs), torch.as_tensor(reset))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    assert np.abs(np.asarray(a_j)).max() > 0.5  # the head's gain spreads the actions
    seq = rng.uniform(-1.5, 1.5, (B, EP_T + 1, 3, 18))
    for s in (seq, seq[:, :-1]):
        want = jax.jit(jalgo._actor_rollout)(ts_j.actor_params, jnp.asarray(s))
        np.testing.assert_allclose(talgo.eval_actions_episode(ts, t(s)).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_grads_match_jax(case):
    kw = CASES[case]
    jalgo, ts_j, talgo, ts = _pair(**kw)
    M = 6
    b = episodes(1, M, EP_T, 3, 18, 2, False)
    key = jax.random.PRNGKey(7)

    def loss(p):
        return jalgo._losses(p["actor"], p["critic"], ts_j, {k: jnp.asarray(v) for k, v in b.items()}, key)

    (total_j, aux_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {"actor": ts_j.actor_params, "critic": ts_j.critic_params})
    c_l, a_l = talgo._losses(ts, {k: t(v) for k, v in b.items()}, draws_of(key, M, talgo.cfg.twin))
    np.testing.assert_allclose(float((c_l.sum() + a_l.sum()).detach()), float(total_j), **TOL)
    np.testing.assert_allclose(float(c_l.detach().mean()), float(aux_j["critic_loss"]), **TOL)
    np.testing.assert_allclose(float(a_l.detach().mean()), float(aux_j["actor_loss"]), **TOL)
    g_a = grads_of(a_l.sum(), list(ts.actor.parameters()))
    g_c = torch.autograd.grad(c_l.sum(), list(ts.critic.parameters()))
    assert_trees({"actor": grads_tree(ts.actor, g_a), "critic": grads_tree(ts.critic, g_c)}, g_j, 1e-10, 1e-10)
    assert not np.asarray(g_j["actor"]["params"]["log_std"]).any()  # unused by the loss, as in the port


@pytest.mark.parametrize("case", list(CASES))
def test_update_once_matches_jax(case):
    """Three updates on three batches, the update key ``fold_in(k, 3)`` as
    train_step derives it: actors, critics, both targets and the losses
    (1e-9)."""
    jalgo, ts_j, talgo, ts = _pair(**CASES[case])
    M = 5
    update = jax.jit(jalgo._update_once)
    for k in range(3):
        b = episodes(10 + k, M, EP_T, 3, 18, 2, False)
        key = jax.random.fold_in(jax.random.PRNGKey(20 + k), 3)
        ts_j, aux_j = update(ts_j, {k2: jnp.asarray(v) for k2, v in b.items()}, key)
        aux_t = talgo._update_once(ts, {k2: t(v) for k2, v in b.items()}, draws_of(key, M, talgo.cfg.twin))
        for name in aux_j:
            np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]), rtol=1e-9, atol=1e-9, err_msg=name)
    for mod, tree in ((ts.actor, ts_j.actor_params), (ts.critic, ts_j.critic_params),
                      (ts.target_actor, ts_j.target_actor_params), (ts.target_critic, ts_j.target_critic_params)):
        assert_module(mod, tree)
    assert ts.grad_updates == int(ts_j.grad_updates) == 3
    assert ts.actor_opt.count == ts.critic_opt.count == 3  # RMATD3's actor moves every update too


@pytest.mark.parametrize("twin", [False, True])
def test_collection_matches_jax(twin):
    """B=4 fresh episodes of T=5 steps from JAX's reset states, the action
    noise ``noise · high · normal`` from JAX's per-step keys, clipped to
    ±high_action."""
    jalgo, ts_j, talgo, ts = _pair(twin=twin)
    B = jalgo.num_envs
    ts_j, ts.noise = ts_j.replace(noise=jnp.asarray(0.9, jnp.float64)), 0.9  # enough for the clip to act
    _, act, _ = replay_episodes(jalgo, ts_j, talgo, ts, jax.random.PRNGKey(3),
                                lambda k: {"normal": per_step(step_keys(k, EP_T), lambda kk: jnormal(kk, (B, 3, 2)))})
    assert float(act.abs().max()) <= 1.0 and (act.abs() == 1.0).any()  # the clip acts


@pytest.mark.parametrize("mask_done", [True, False])
def test_default_losses_ignore_terminal_obs(mask_done):
    """With ``mask_done`` (the default) the losses and every gradient are
    the same bits whatever the episodes' last observation holds: the
    JAX package's post-reset ``obs[:, T]`` reaches no default result.
    Without it the last observation counts."""
    _, _, talgo, ts = _pair(mask_done=mask_done)
    b = episodes(4, 5, EP_T, 3, 18, 2, False)

    def losses(batch):
        c_l, a_l = talgo._losses(ts, batch, {})
        params = list(ts.critic.parameters())
        return [c_l.detach(), a_l.detach(), *torch.autograd.grad(c_l.sum(), params)]

    if mask_done:
        assert_ignores_terminal_obs(losses, b)
    else:
        with pytest.raises(AssertionError):
            assert_ignores_terminal_obs(losses, b)


def test_noise_decays_once_a_collection():
    """``max(explore_min, noise − explore_decay · B · T)`` after each
    collection; ``env_steps`` by B · T."""
    algo = RMADDPG(gt.make_env("formation_hd_env", num_agents=3, episode_length=4),
                   RMADDPGConfig(explore_decay=0.004, buffer_episodes=8, gru_hidden=8, critic_hidden=(8,)),
                   num_envs=2, device="cpu")
    g = torch.Generator()
    ts, buf = algo.init(g)
    noise = 0.1
    for k in range(3):
        algo._collect(ts, buf, g)
        noise = max(0.05, noise - 0.004 * 2 * 4)
        assert ts.noise == pytest.approx(noise, rel=1e-12) and ts.env_steps == 8 * (k + 1)
    assert ts.noise == 0.05 and buf.size == 6


def test_episode_buffer_matches_jax():
    """Inserts across the ring's end and a batch gathered at the indices
    JAX's ``sample`` draws; the port's own draws in [0, size)."""
    cap, T, rng = 7, 3, np.random.RandomState(0)
    jb, tb = JEpisodeBuffer.create(cap, T, 3, 4, 2), EpisodeBuffer(cap, T, 3, 4, 2, dtype=F64)
    for b in (3, 3, 3):
        rows = (rng.normal(size=(b, T + 1, 3, 4)), rng.normal(size=(b, T, 3, 2)), rng.normal(size=(b, T, 3)))
        jb = jb.insert(*map(jnp.asarray, rows))
        tb.insert(*(torch.as_tensor(x) for x in rows))
        assert (tb.ptr, tb.size) == (int(jb.ptr), int(jb.size))
    assert (tb.ptr, tb.size) == (2, 7)
    for name in ("obs", "action", "reward"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    key = jax.random.PRNGKey(4)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(jb.size, 1))
    want = jb.sample(key, 16)
    for k, v in tb.gather(torch.as_tensor(np.array(idx))).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)
    g = torch.Generator()
    g.manual_seed(0)
    s = tb.sample(g, 200)
    assert s["obs"].shape == (200, T + 1, 3, 4)
    empty = EpisodeBuffer(cap, T, 3, 4, 2)
    assert empty.sample(g, 3)["reward"].shape == (3, T, 3)  # max(size, 1): the zero slot


@pytest.mark.parametrize("name", ["rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn"])
def test_metric_keys_match_jax(name):
    """One train_step of each package at a tiny size (updates included,
    the benchmark quartet on; JAX's traced by ``eval_shape``): the same
    metric keys."""
    sets = ["buffer_episodes=8", "batch_episodes=2", "episodes_per_iter=1", "updates_per_iter=1", "gru_hidden=8"]
    discrete = name in ("rqmix", "rvdn")
    jenv = ft.make_env("formation_hd_env", num_agents=3, episode_length=3, benchmark=True, discrete_action=discrete)
    jalgo = jreg.make_algo(name, jenv, num_envs=2, sets=sets)
    state_j = jax.eval_shape(jalgo.init, jax.random.PRNGKey(0))
    *_, m_j = jax.eval_shape(jalgo.train_step, *state_j, jax.random.PRNGKey(1))
    tenv = gt.make_env("formation_hd_env", num_agents=3, episode_length=3, benchmark=True, discrete_action=discrete)
    talgo = make_algo(name, tenv, 2, sets=sets, device="cpu")
    g = torch.Generator()
    *_, m_t = talgo.train_step(*talgo.init(g), g)
    assert sorted(m_t) == sorted(m_j)
    assert m_t["buffer_episodes"] == 2
    assert all(np.isfinite(float(v)) for v in m_t.values()) and float(m_t[talgo.loss_keys[0]]) > 0


# -- the JAX package's behaviour tests, ported -----------------------------------

def test_rmaddpg_and_rmatd3_run():
    env = gt.make_env("formation_hd_env", num_agents=3, episode_length=8)
    for twin in (False, True):
        algo = RMADDPG(env, RMADDPGConfig(buffer_episodes=64, batch_episodes=4, episodes_per_iter=2,
                                          updates_per_iter=2, twin=twin), num_envs=4, device="cpu")
        g = torch.Generator()
        ts, buf = algo.init(g)
        for _ in range(3):
            ts, buf, m = algo.train_step(ts, buf, g)
        assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
        acts = algo.eval_actions_episode(ts, torch.zeros(2, 8, 3, 18))
        assert acts.shape == (2, 8, 3, 2) and float(acts.abs().max()) <= 1.0


@pytest.mark.parametrize("name,iters", [("rmaddpg", 30), ("rqmix", 60)])
def test_recurrent_learning_signal(name, iters):
    """The per-step training reward trends up over a miniature of the
    reference's zoo protocol (JAX ``test_recurrent_learning_signal``)."""
    env = gt.make_env("formation_hd_env", num_agents=3, episode_length=8, discrete_action=name == "rqmix")
    algo = make_algo(name, env, 16, sets=["episodes_per_iter=4", "updates_per_iter=8", "batch_episodes=16",
                                          "buffer_episodes=256"]
                     + (["eps_anneal_steps=5000"] if name == "rqmix" else ["lr_actor=1e-3", "lr_critic=1e-3"]),
                     device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    state = list(algo.init(g))
    rews = []
    for _ in range(iters):
        *state, m = algo.train_step(*state, g)
        rews.append(float(m["mean_step_reward"]))
    assert np.isfinite(rews).all()
    assert np.mean(rews[-5:]) > np.mean(rews[:5]) + 0.1, rews


def test_checkpoint_round_trip(tmp_path):
    """RMATD3: the whole tuple, the episode buffer, the noise and the
    generator; the next iteration bit for bit."""
    def make():
        return RMADDPG(gt.make_env("formation_hd_env", num_agents=3, episode_length=3),
                       RMADDPGConfig(twin=True, buffer_episodes=10, batch_episodes=4, episodes_per_iter=2,
                                     updates_per_iter=2, gru_hidden=8, critic_hidden=(8, 8)),
                       num_envs=3, device="cpu")

    algo, state = checkpoint_round_trip(make, tmp_path)
    # 18 episodes into a ring of 10: it wrapped
    assert (state[1].size, state[1].ptr, state[0].grad_updates) == (10, 8, 6) and state[0].noise < 0.1
