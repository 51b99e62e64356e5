"""The port's RMASAC against the JAX package's, in float64 on the same
parameters, episodes and draws: the recurrent squashed actor's converter
round trip (its log-std head is flax's ``Dense_2``), one ``_actor_step``
and the sampled rollouts (1e-10); ``_losses`` and every gradient leaf, the
per-agent temperatures included, with α tuned and fixed (1e-10; the next
actions' draws from ``split(k_next, T+1)``, the fresh ones' from
``split(k_new, T)``); three ``_update_once`` calls (1e-9); the collection
against JAX's; the losses blind to the episodes' last observation; the JAX
package's ``test_rmasac_runs_and_tunes_alpha``, ported; a checkpoint round
trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_formation_tpu.algos import RMASAC as JRMASAC, RMASACConfig as JRMASACConfig
from gym_formation_tpu.algos.rmasac import RecurrentSquashedActor, RMASACState as JRMASACState

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import RMASAC, RMASACConfig
from gym_formation_tpu_torch.models.networks import recurrent_squashed_actor_from_flax
from _offpolicy import (  # noqa: F401 (one_torch_thread: a module fixture)
    EP_T, F64, assert_ignores_terminal_obs, assert_module, assert_round_trip, assert_trees, checkpoint_round_trip,
    episodes, f64, grads_tree, jenv_f64, jnormal, np_tree, one_torch_thread, per_step, perturbed, replay_episodes,
    scaled_head, step_keys, t,
)

TOL = dict(rtol=1e-10, atol=1e-10)
CASES = {"tuned": dict(), "fixed_alpha": dict(autotune_alpha=False)}
SMALL = dict(gru_hidden=16, critic_hidden=(16, 16), buffer_episodes=16)


@functools.lru_cache(maxsize=None)
def _jax(B, kw):
    jalgo = JRMASAC(jenv_f64(), JRMASACConfig(**dict(kw)), num_envs=B)
    ts0 = jax.jit(lambda k: jalgo.init(k)[0])(jax.random.PRNGKey(0))
    a, c = f64(ts0.actor_params), f64(ts0.critic_params)
    a = scaled_head(a, head="Dense_1")
    tc = perturbed(c, 2)
    log_alpha = jnp.log(jnp.asarray([0.1, 0.2, 0.35]))
    ts_j = JRMASACState(actor_params=a, critic_params=c, target_critic_params=tc, log_alpha=log_alpha,
                        actor_opt=jalgo.actor_tx.init(a), critic_opt=jalgo.critic_tx.init(c),
                        alpha_opt=jalgo.alpha_tx.init(log_alpha), env_steps=jnp.zeros((), jnp.int32))
    return jalgo, ts_j, np_tree({"actor": a, "critic": c, "target_critic": tc, "log_alpha": log_alpha})


def _pair(B=4, **cfg_kw):
    kw = dict(SMALL, **cfg_kw)
    jalgo, ts_j, params = _jax(B, tuple(sorted(kw.items())))
    talgo = RMASAC(gt.make_env("formation_hd_env", num_agents=3, episode_length=EP_T), RMASACConfig(**kw),
                   num_envs=B, device="cpu", dtype=F64)
    return jalgo, ts_j, talgo, talgo.state_from_flax(params)


def draws_of(key, M):
    """The update's draws as JAX's ``_losses`` makes them: ``k_next, k_new =
    split(key)``, one normal a step from ``split(k_next, T+1)`` and
    ``split(k_new, T)``."""
    k_next, k_new = jax.random.split(key)
    normal = lambda k: jnormal(k, (M, 3, 2))
    return {"next": per_step(step_keys(k_next, EP_T + 1), normal), "new": per_step(step_keys(k_new, EP_T), normal)}


def test_recurrent_squashed_actor_round_trip():
    """``Dense_0`` (embed), ``GRUCell_0``, ``Dense_1`` (mean) and ``Dense_2``
    (log-std), stacked over 3 agents, exactly."""
    inputs = (jnp.zeros((1, 16)), jnp.zeros((1, 18)), jnp.zeros((1,), bool))
    assert_round_trip(RecurrentSquashedActor(2, 16), inputs, recurrent_squashed_actor_from_flax)


def test_actor_step_and_rollout_match_jax():
    B = 5
    jalgo, ts_j, talgo, ts = _pair()
    rng = np.random.RandomState(0)
    carry, obs = rng.normal(size=(B, 3, 16)), rng.uniform(-1.5, 1.5, (B, 3, 18))
    reset = np.array([True, False, True, False, False])
    h_j, (m_j, ls_j) = jax.jit(jalgo._actor_step)(ts_j.actor_params, jnp.asarray(carry), jnp.asarray(obs),
                                                  jnp.asarray(reset))
    with torch.no_grad():
        h_t, (m_t, ls_t) = talgo._actor_step(ts.actor, t(carry), t(obs), torch.as_tensor(reset))
    for got, want in ((h_t, h_j), (m_t, m_j), (ls_t, ls_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    seq, key = rng.uniform(-1.5, 1.5, (B, EP_T + 1, 3, 18)), jax.random.PRNGKey(2)
    a_j, lp_j = jax.jit(jalgo._actor_rollout)(ts_j.actor_params, jnp.asarray(seq), key)
    eps = per_step(step_keys(key, EP_T + 1), lambda k: jnormal(k, (B, 3, 2)))
    with torch.no_grad():
        a_t, lp_t = talgo._actor_rollout(ts.actor, t(seq), eps)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_grads_match_jax(case):
    jalgo, ts_j, talgo, ts = _pair(**CASES[case])
    M = 6
    b = episodes(1, M, EP_T, 3, 18, 2, False)
    key = jax.random.PRNGKey(7)
    params = {"actor": ts_j.actor_params, "critic": ts_j.critic_params, "log_alpha": ts_j.log_alpha}
    (total_j, aux_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jalgo._losses(p, ts_j, {k: jnp.asarray(v) for k, v in b.items()}, key), has_aux=True))(params)
    c_l, a_l, al_l, ent = talgo._losses(ts, {k: t(v) for k, v in b.items()}, draws_of(key, M))
    total = c_l.sum() + a_l.sum() + (al_l.sum() if talgo.cfg.autotune_alpha else 0.0)
    np.testing.assert_allclose(float(total.detach()), float(total_j), **TOL)
    for name, v in (("critic_loss", c_l), ("actor_loss", a_l), ("entropy", ent),
                    ("alpha", torch.exp(ts.log_alpha))):
        np.testing.assert_allclose(float(v.detach().mean()), float(aux_j[name]), err_msg=name, **TOL)
    g_a = torch.autograd.grad(a_l.sum(), list(ts.actor.parameters()))
    g_c = torch.autograd.grad(c_l.sum(), list(ts.critic.parameters()))
    g_al = torch.autograd.grad(al_l.sum(), [ts.log_alpha])[0] if talgo.cfg.autotune_alpha else torch.zeros(3)
    assert_trees({"actor": grads_tree(ts.actor, g_a), "critic": grads_tree(ts.critic, g_c),
                  "log_alpha": g_al.numpy()}, g_j, 1e-10, 1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_update_once_matches_jax(case):
    """Three updates: actors, critics, the target and the temperatures
    (held with autotune_alpha=False), and the metrics (1e-9)."""
    jalgo, ts_j, talgo, ts = _pair(**CASES[case])
    M = 5
    update = jax.jit(jalgo._update_once)
    for k in range(3):
        b = episodes(10 + k, M, EP_T, 3, 18, 2, False)
        key = jax.random.fold_in(jax.random.PRNGKey(20 + k), 3)
        ts_j, aux_j = update(ts_j, {k2: jnp.asarray(v) for k2, v in b.items()}, key)
        aux_t = talgo._update_once(ts, {k2: t(v) for k2, v in b.items()}, draws_of(key, M))
        for name in aux_j:
            np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]), rtol=1e-9, atol=1e-9, err_msg=name)
    for mod, tree in ((ts.actor, ts_j.actor_params), (ts.critic, ts_j.critic_params),
                      (ts.target_critic, ts_j.target_critic_params)):
        assert_module(mod, tree)
    np.testing.assert_allclose(ts.log_alpha.detach().numpy(), np.asarray(ts_j.log_alpha), rtol=1e-9, atol=1e-9)
    moved = not np.allclose(ts.log_alpha.detach().numpy(), np.log([0.1, 0.2, 0.35]), rtol=0, atol=0)
    assert moved == talgo.cfg.autotune_alpha
    assert ts.alpha_opt.count == (3 if talgo.cfg.autotune_alpha else 0)


def test_collection_matches_jax():
    """Fresh episodes from JAX's reset states, each step a policy sample on
    JAX's per-step normal."""
    jalgo, ts_j, talgo, ts = _pair()
    B = jalgo.num_envs
    _, act, _ = replay_episodes(jalgo, ts_j, talgo, ts, jax.random.PRNGKey(3),
                                lambda k: {"eps": per_step(step_keys(k, EP_T), lambda kk: jnormal(kk, (B, 3, 2)))})
    assert float(act.abs().max()) <= 1.0


def test_losses_ignore_terminal_obs():
    """RMASAC always masks the last step's bootstrap: the losses and every
    gradient are the same bits whatever ``obs[:, T]`` holds."""
    _, _, talgo, ts = _pair()
    b = episodes(4, 5, EP_T, 3, 18, 2, False)
    draws = draws_of(jax.random.PRNGKey(1), 5)

    def losses(batch):
        c_l, a_l, al_l, _ = talgo._losses(ts, batch, draws)
        return [c_l.detach(), a_l.detach(), al_l.detach(),
                *torch.autograd.grad(c_l.sum(), list(ts.critic.parameters()))]

    assert_ignores_terminal_obs(losses, b)


def test_rmasac_runs_and_tunes_alpha():
    """JAX ``test_rmasac_runs_and_tunes_alpha``."""
    algo = RMASAC(gt.make_env("formation_hd_env", num_agents=3, episode_length=8),
                  RMASACConfig(buffer_episodes=64, batch_episodes=4, episodes_per_iter=2, updates_per_iter=2),
                  num_envs=4, device="cpu")
    g = torch.Generator()
    ts, buf = algo.init(g)
    for _ in range(3):
        ts, buf, m = algo.train_step(ts, buf, g)
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    assert float(m["alpha"]) != RMASACConfig().init_alpha
    assert np.isfinite(float(m["entropy"]))


def test_checkpoint_round_trip(tmp_path):
    """The whole tuple, the temperatures and their Adam included."""
    def make():
        return RMASAC(gt.make_env("formation_hd_env", num_agents=3, episode_length=3),
                      RMASACConfig(buffer_episodes=12, batch_episodes=4, episodes_per_iter=2, updates_per_iter=2,
                                   gru_hidden=8, critic_hidden=(8, 8)), num_envs=3, device="cpu")

    algo, state = checkpoint_round_trip(make, tmp_path)
    assert state[0].alpha_opt.count == 6 and state[0].env_steps == 3 * 2 * 3 * 3
