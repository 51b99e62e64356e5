"""The port's QMIX and VDN against the JAX package's, in float64 on the same
parameters and batches: ``_loss`` and every gradient leaf of the Q network
and the mixer (1e-10), three ``_update_once`` calls with soft and hard
targets (1e-9), the ε schedule and the ε-greedy on JAX's draws, the JAX
package's QMix behaviour test, ported, and a checkpoint round trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import QMix as JQMix, QMixConfig as JQMixConfig
from gym_formation_tpu.algos.qmix import AgentQNet, QMixer as JQMixer, QMixState as JQMixState

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import QMix, QMixConfig
from gym_formation_tpu_torch.models.networks import logits_actor_from_flax, qmixer_from_flax
from _offpolicy import (
    F64, H, assert_module, assert_round_trip, assert_trees, batch, checkpoint_round_trip, f64, grads_tree, jbatch,
    np_tree, perturbed, scaled_head, t, tbatch,
)

TOL = dict(rtol=1e-10, atol=1e-10)
CASES = {"qmix": dict(mixer="qmix"), "vdn": dict(mixer="vdn"),
         "qmix_single_q": dict(mixer="qmix", double_q=False, mask_done=True),
         "vdn_hard": dict(mixer="vdn", hard_interval=2)}


@functools.lru_cache(maxsize=None)
def _jax(B, kw):
    jenv = ft.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    jalgo = JQMix(jenv, JQMixConfig(**dict(kw)), num_envs=B)
    n, do = 3, jalgo.obs_dim

    @jax.jit
    def init(key):
        kq, km = jax.random.split(key)
        q = jalgo.qnet.init(kq, jnp.zeros((1, do + n)))
        m = jalgo.mixer.init(km, jnp.zeros((1, n)), jnp.zeros((1, n * do))) if jalgo.cfg.mixer == "qmix" else {}
        return q, m

    q, m = f64(init(jax.random.PRNGKey(0)))
    q = scaled_head(q, by=100.0)
    tq, tm = perturbed(q, 1), perturbed(m, 2)
    ts_j = JQMixState(q_params=q, mixer_params=m, target_q_params=tq, target_mixer_params=tm,
                      opt_state=jalgo.tx.init({"q": q, "mixer": m}), env_steps=jnp.zeros((), jnp.int32),
                      grad_updates=jnp.zeros((), jnp.int32))
    return jalgo, ts_j, np_tree({"q": q, "mixer": m, "target_q": tq, "target_mixer": tm})


def _pair(B=4, **cfg_kw):
    kw = dict(hidden=H, buffer_size=64, mixer_embed=8, **cfg_kw)
    jalgo, ts_j, params = _jax(B, tuple(sorted(kw.items())))
    talgo = QMix(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True), QMixConfig(**kw),
                 num_envs=B, device="cpu", dtype=F64)
    return jalgo, ts_j, talgo, talgo.state_from_flax(params)


@pytest.mark.parametrize("net", ["agent_q", "mixer"])
def test_converters_round_trip(net):
    """AgentQNet (the port's LogitsActor over obs ⊕ id) and QMixer: a flax
    init through ``*_from_flax`` and back, exactly (the mixer's Dense_3 is
    its output layer, Dense_4 the inner one)."""
    if net == "agent_q":
        assert_round_trip(AgentQNet(5, H), (jnp.zeros((1, 21)),), logits_actor_from_flax, stacked=False)
    else:
        assert_round_trip(JQMixer(3, 8), (jnp.zeros((1, 3)), jnp.zeros((1, 54))), qmixer_from_flax, stacked=False)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case):
    jalgo, ts_j, talgo, ts = _pair(**CASES[case])
    b = batch(1, 12, 3, 18, 5, True)
    params = {"q": ts_j.q_params, "mixer": ts_j.mixer_params}
    (loss_j, aux_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jalgo._loss(p, ts_j, jbatch(b)), has_aux=True))(params)
    loss_t, aux_t = talgo._loss(ts, tbatch(b))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), **TOL)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), err_msg=k, **TOL)
    grads = torch.autograd.grad(loss_t, talgo._params(ts.q, ts.mixer))
    nq = len(list(ts.q.parameters()))
    got = {"q": grads_tree(ts.q, grads[:nq]), "mixer": grads_tree(ts.mixer, grads[nq:]) if ts.mixer else {}}
    assert_trees(got, g_j, 1e-10, 1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_update_once_matches_jax(case):
    """Three updates under the shared clipped Adam: the networks, the
    targets (soft, or hard on every second update) and the metrics
    (1e-9)."""
    jalgo, ts_j, talgo, ts = _pair(**CASES[case])
    update = jax.jit(jalgo._update_once)
    for k in range(3):
        b = batch(10 + k, 10, 3, 18, 5, True)
        ts_j, aux_j = update(ts_j, jbatch(b))
        aux_t = talgo._update_once(ts, tbatch(b))
        for name in aux_j:
            np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]), rtol=1e-9, atol=1e-9, err_msg=name)
    pairs = [(ts.q, ts_j.q_params), (ts.target_q, ts_j.target_q_params)]
    if ts.mixer is not None:
        pairs += [(ts.mixer, ts_j.mixer_params), (ts.target_mixer, ts_j.target_mixer_params)]
    for mod, tree in pairs:
        assert_module(mod, tree)
    assert ts.grad_updates == int(ts_j.grad_updates) == 3 and ts.opt.count == 3


def test_epsilon_schedule_and_explore_match_jax():
    """ε at several env-step counts, and the ε-greedy one-hots on the draws
    JAX makes from a key (``split`` into the ε uniforms and the random
    actions), against JAX's explore_actions; every action a one-hot."""
    B = 16
    jalgo, ts_j, talgo, ts = _pair(B=B, eps_anneal_steps=1000)
    for steps in (0, 1, 333, 999, 1000, 50_000):
        ts.env_steps = steps
        # JAX divides the int32 step count in float32
        np.testing.assert_allclose(talgo.epsilon(ts), float(jalgo.epsilon(ts_j.replace(
            env_steps=jnp.asarray(steps, jnp.int32)))), rtol=1e-6)
    obs = np.random.RandomState(2).uniform(-1.5, 1.5, (B, 3, 18))
    key = jax.random.PRNGKey(3)
    ts.env_steps = 500  # ε = 0.525: both branches
    a_j = jax.jit(jalgo.explore_actions)(ts_j.replace(env_steps=jnp.asarray(500, jnp.int32)), jnp.asarray(obs), key)
    k_eps, k_uni = jax.random.split(key)
    draws = {"uniform": t(jax.random.uniform(k_eps, (B, 3))),
             "rand": torch.as_tensor(np.array(jax.random.randint(k_uni, (B, 3), 0, 5)))}
    with torch.no_grad():
        a_t = talgo._explore(ts, t(obs), draws)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    greedy = talgo.eval_actions(ts, t(obs))
    took = (draws["uniform"] < talgo.epsilon(ts)).numpy()
    assert took.any() and (~took).any()
    np.testing.assert_array_equal(a_t.numpy()[~took], greedy.numpy()[~took])
    a_g = talgo.explore_actions(ts, t(obs), torch.Generator())
    for a in (a_t, a_g):
        assert torch.equal(a.sum(-1), torch.ones(B, 3, dtype=F64)) and set(a.unique().tolist()) == {0.0, 1.0}


@pytest.mark.parametrize("mixer", ["qmix", "vdn"])
def test_qmix_vdn_run_and_learn_shapes(mixer):
    """JAX ``test_qmix_vdn_run_and_learn_shapes``."""
    algo = QMix(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True),
                QMixConfig(mixer=mixer, buffer_size=2048, steps_per_iter=8, updates_per_iter=2, batch_size=64,
                           eps_anneal_steps=100), num_envs=8, device="cpu")
    g = torch.Generator()
    state = algo.init(g)
    for _ in range(3):
        *state, m = algo.train_step(*state, g)
    assert np.isfinite(float(m["q_loss"])) and float(m["q_loss"]) > 0
    assert float(m["epsilon"]) < 1.0
    acts = algo.eval_actions(state[0], state[3])
    assert acts.shape == (8, 3, 5)
    assert torch.equal(acts.sum(-1), torch.ones(8, 3))
    assert (state[0].mixer is None) == (mixer == "vdn")


def test_qmix_refuses_continuous_env():
    with pytest.raises(ValueError, match="discrete_action"):
        QMix(gt.make_env("formation_hd_env", num_agents=3), num_envs=4, device="cpu")
    with pytest.raises(ValueError, match="unknown mixer"):
        QMix(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True), QMixConfig(mixer="qtran"),
             num_envs=4, device="cpu")


@pytest.mark.parametrize("mixer", ["qmix", "vdn"])
def test_checkpoint_round_trip(mixer, tmp_path):
    def make():
        return QMix(gt.make_env("formation_hd_env", num_agents=3, episode_length=3, discrete_action=True),
                    QMixConfig(mixer=mixer, buffer_size=40, batch_size=8, steps_per_iter=3, updates_per_iter=2,
                               hidden=(16, 16), mixer_embed=8), num_envs=4, device="cpu")

    algo, state = checkpoint_round_trip(make, tmp_path)
    assert state[0].opt.count == 6
