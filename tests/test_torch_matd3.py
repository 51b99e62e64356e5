"""The port's MATD3 against the JAX package's, in float64 on the same
parameters, batches and draws (the target smoothing's normals from
``noise_key``, the discrete target sample's Gumbel noise from
``fold_in(noise_key, n_agents)``, the actor loss's from ``fold_in(noise_key,
i)``): ``_losses`` and every gradient leaf (1e-10), three ``_update_once``
calls over both delay phases (1e-9), the JAX package's MATD3 behaviour
tests, ported, and a checkpoint round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_formation_tpu.algos import MATD3 as JMATD3, MATD3Config as JMATD3Config
from gym_formation_tpu.algos.matd3 import TwinQCritic

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import MATD3, MATD3Config
from gym_formation_tpu_torch.models.networks import twin_q_critic_from_flax
from _offpolicy import (
    H, assert_ddpg_state, assert_round_trip, assert_trees, batch, checkpoint_round_trip, ddpg_pair, grads_tree,
    jbatch, jgumbel, jnormal, t, tbatch,
)

TOL = dict(rtol=1e-10, atol=1e-10)


def _pair(discrete):
    return ddpg_pair(JMATD3, JMATD3Config, MATD3, MATD3Config, discrete=discrete)


def draws_of(noise_key, M, n, da, discrete):
    if not discrete:
        return {"target_noise": t(jnormal(noise_key, (M, n, da)))}
    g = np.stack([jgumbel(jax.random.fold_in(noise_key, i), (M, da)) for i in range(n)], 1)
    return {"gumbel": t(g), "target_gumbel": t(jgumbel(jax.random.fold_in(noise_key, n), (M, n, da)))}


def test_twin_critic_round_trip():
    """The stacked TwinQCritic: a vmapped flax init through
    ``twin_q_critic_from_flax`` and back, exactly."""
    assert_round_trip(TwinQCritic(0.5, H), (jnp.zeros((1, 54)), jnp.zeros((1, 6))), twin_q_critic_from_flax,
                      max_action=0.5)


@pytest.mark.parametrize("discrete", [False, True])
def test_losses_and_grads_match_jax(discrete):
    jalgo, ts_j, talgo, ts = _pair(discrete)
    M, da = 12, talgo.act_dim
    b = batch(1, M, 3, 18, da, discrete)
    nk = jax.random.PRNGKey(7)

    def loss(p):
        return jalgo._losses(p["actor"], p["critic"], ts_j, dict(jbatch(b), noise_key=nk))

    (total_j, aux_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {"actor": ts_j.actor_params, "critic": ts_j.critic_params})
    c_l, a_l, td = talgo._losses(ts, tbatch(b), draws_of(nk, M, 3, da, discrete))
    np.testing.assert_allclose(float((c_l.sum() + a_l.sum()).detach()), float(total_j), **TOL)
    np.testing.assert_allclose(float(c_l.detach().mean()), float(aux_j["critic_loss"]), **TOL)
    np.testing.assert_allclose(float(a_l.detach().mean()), float(aux_j["actor_loss"]), **TOL)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(aux_j["td_abs"]), **TOL)
    g_a = torch.autograd.grad(a_l.sum(), list(ts.actor.parameters()))
    g_c = torch.autograd.grad(c_l.sum(), list(ts.critic.parameters()))
    assert_trees({"actor": grads_tree(ts.actor, g_a), "critic": grads_tree(ts.critic, g_c)}, g_j, 1e-10, 1e-10)


@pytest.mark.parametrize("discrete", [False, True])
def test_update_once_matches_jax_over_both_delay_phases(discrete):
    """Updates 0, 1, 2 (policy_delay 2): the actor and both targets move on
    0 and 2 only, the critics on all three; against JAX (1e-9)."""
    jalgo, ts_j, talgo, ts = _pair(discrete)
    M, da = 10, talgo.act_dim
    update = jax.jit(jalgo._update_once)
    for k in range(3):
        before = {n: [p.detach().clone() for p in getattr(ts, n).parameters()]
                  for n in ("actor", "target_actor", "target_critic", "critic")}
        b = batch(10 + k, M, 3, 18, da, discrete)
        nk = jax.random.PRNGKey(20 + k)
        ts_j, aux_j = update(ts_j, dict(jbatch(b), noise_key=nk))
        aux_t = talgo._update_once(ts, tbatch(b), draws_of(nk, M, 3, da, discrete))
        for key in aux_j:
            np.testing.assert_allclose(np.asarray(aux_t[key]), np.asarray(aux_j[key]), rtol=1e-9, atol=1e-9,
                                       err_msg=key)
        assert_ddpg_state(ts, ts_j)
        for name, ps in before.items():
            same = all(torch.equal(p, q) for p, q in zip(ps, getattr(ts, name).parameters()))
            assert same == (k == 1 and name != "critic"), (k, name)
    assert ts.grad_updates == int(ts_j.grad_updates) == 3
    assert (ts.actor_opt.count, ts.critic_opt.count) == (2, 3)


def test_matd3_runs_and_delays_actor():
    """JAX ``test_matd3_runs_and_delays_actor``."""
    algo = MATD3(gt.make_env("formation_hd_env", num_agents=3),
                 MATD3Config(buffer_size=2048, steps_per_iter=8, updates_per_iter=4, batch_size=64), num_envs=8,
                 device="cpu")
    g = torch.Generator()
    state = algo.init(g)
    for _ in range(3):
        *state, m = algo.train_step(*state, g)
    ts, obs = state[0], state[3]
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    assert ts.grad_updates == 12  # 3 iterations × 4 updates (a batch in the buffer from the first)
    assert ts.actor_opt.count == 6
    assert float(algo.eval_actions(ts, obs).abs().max()) <= 1.0


def test_matd3_discrete_runs():
    """JAX ``test_matd3_discrete_runs``."""
    algo = MATD3(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True),
                 MATD3Config(buffer_size=1024, steps_per_iter=16, updates_per_iter=2, batch_size=64), num_envs=8,
                 device="cpu")
    g = torch.Generator()
    state = algo.init(g)
    for _ in range(2):
        *state, m = algo.train_step(*state, g)
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    ev = algo.eval_actions(state[0], state[3])
    assert torch.equal(ev.sum(-1), torch.ones(8, 3))


def test_checkpoint_round_trip(tmp_path):
    """The whole tuple, the twin critics and the delay's count included."""
    def make():
        return MATD3(gt.make_env("formation_hd_env", num_agents=3, episode_length=3),
                     MATD3Config(buffer_size=40, batch_size=8, steps_per_iter=3, updates_per_iter=3,
                                 hidden=(16, 16)), num_envs=4, device="cpu")

    # 9 updates before the checkpoint: the restored run starts on a skipped actor
    algo, state = checkpoint_round_trip(make, tmp_path, iters=3)
    assert state[0].grad_updates == 12
