"""The port's MASAC against the JAX package's, in float64 on the same
parameters, batches and draws (the next and fresh actions' noise from
JAX's ``split(key)``): ``_losses`` and every gradient leaf, the per-agent
temperatures included (1e-10), three ``_update_once`` calls (1e-9),
``sample_squashed``, the exploration and its warm-up switch, the JAX
package's MASAC behaviour tests, ported, and a checkpoint round trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MASAC as JMASAC, MASACConfig as JMASACConfig
from gym_formation_tpu.algos.masac import (
    MASACState as JMASACState, SquashedGaussianActor, sample_squashed as jsample_squashed,
)

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import MASAC, MASACConfig
from gym_formation_tpu_torch.algos.masac import sample_squashed
from gym_formation_tpu_torch.models.networks import squashed_actor_from_flax
from _offpolicy import (
    F64, H, assert_module, assert_round_trip, assert_trees, batch, checkpoint_round_trip, f64, grads_tree, jbatch,
    jgumbel, jnormal, np_tree, perturbed, scaled_head, t, tbatch,
)

TOL = dict(rtol=1e-10, atol=1e-10)
CASES = {"continuous": dict(), "discrete": dict(discrete=True),
         "fixed_alpha": dict(autotune_alpha=False, mask_done=True)}


@functools.lru_cache(maxsize=None)
def _jax(discrete, B, kw):
    jenv = ft.make_env("formation_hd_env", num_agents=3, discrete_action=discrete)
    jalgo = JMASAC(jenv, JMASACConfig(**dict(kw)), num_envs=B)
    n, do, da = 3, jalgo.obs_dim, jalgo.act_dim

    @jax.jit
    def init(key):
        ka, kc = jax.random.split(key)
        a = jax.vmap(lambda k: jalgo.actor.init(k, jnp.zeros((1, do))))(jax.random.split(ka, n))
        c = jax.vmap(lambda k: jalgo.critic.init(k, jnp.zeros((1, n * do)), jnp.zeros((1, n * da))))(
            jax.random.split(kc, n))
        return a, c

    a, c = f64(init(jax.random.PRNGKey(0)))
    a = scaled_head(a)
    tc = perturbed(c, 2)
    log_alpha = jnp.log(jnp.asarray([0.1, 0.2, 0.35]))
    ts_j = JMASACState(actor_params=a, critic_params=c, target_critic_params=tc, log_alpha=log_alpha,
                       actor_opt=jalgo.actor_tx.init(a), critic_opt=jalgo.critic_tx.init(c),
                       alpha_opt=jalgo.alpha_tx.init(log_alpha), env_steps=jnp.zeros((), jnp.int32))
    return jalgo, ts_j, np_tree({"actor": a, "critic": c, "target_critic": tc, "log_alpha": log_alpha})


def _pair(discrete=False, B=4, **cfg_kw):
    kw = dict(hidden=H, buffer_size=64, **cfg_kw)
    jalgo, ts_j, params = _jax(discrete, B, tuple(sorted(kw.items())))
    talgo = MASAC(gt.make_env("formation_hd_env", num_agents=3, discrete_action=discrete), MASACConfig(**kw),
                  num_envs=B, device="cpu", dtype=F64)
    return jalgo, ts_j, talgo, talgo.state_from_flax(params)


def draws_of(key, M, n, da, discrete):
    k_next, k_new = jax.random.split(key)
    draw = jgumbel if discrete else jnormal
    return {"next": t(draw(k_next, (M, n, da))), "new": t(draw(k_new, (M, n, da)))}


def test_squashed_actor_round_trip():
    """The stacked SquashedGaussianActor: a vmapped flax init through
    ``squashed_actor_from_flax`` and back, exactly."""
    assert_round_trip(SquashedGaussianActor(2, 1.0, H), (jnp.zeros((1, 18)),), squashed_actor_from_flax)


def test_sample_squashed_matches_jax():
    rng = np.random.RandomState(0)
    mean, log_std = rng.normal(size=(6, 3, 2)) * 2, rng.uniform(-3, 1, (6, 3, 2))
    key = jax.random.PRNGKey(1)
    a_j, logp_j = jsample_squashed(key, jnp.asarray(mean), jnp.asarray(log_std), 0.7)
    a_t, logp_t = sample_squashed(t(jnormal(key, (6, 3, 2))), t(mean), t(log_std), 0.7)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_grads_match_jax(case):
    kw = CASES[case]
    jalgo, ts_j, talgo, ts = _pair(**kw)
    M, da = 12, talgo.act_dim
    b = batch(1, M, 3, 18, da, talgo.discrete)
    key = jax.random.PRNGKey(7)
    params = {"actor": ts_j.actor_params, "critic": ts_j.critic_params, "log_alpha": ts_j.log_alpha}
    (total_j, aux_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jalgo._losses(p, ts_j, jbatch(b), key), has_aux=True))(params)
    c_l, a_l, al_l, ent = talgo._losses(ts, tbatch(b), draws_of(key, M, 3, da, talgo.discrete))
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
    kw = CASES[case]
    jalgo, ts_j, talgo, ts = _pair(**kw)
    M, da = 10, talgo.act_dim
    update = jax.jit(jalgo._update_once)
    for k in range(3):
        b = batch(10 + k, M, 3, 18, da, talgo.discrete)
        key = jax.random.PRNGKey(20 + k)
        ts_j, aux_j = update(ts_j, jbatch(b), key)
        aux_t = talgo._update_once(ts, tbatch(b), draws_of(key, M, 3, da, talgo.discrete))
        for name in aux_j:
            np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]), rtol=1e-9, atol=1e-9, err_msg=name)
    for mod, tree in ((ts.actor, ts_j.actor_params), (ts.critic, ts_j.critic_params),
                      (ts.target_critic, ts_j.target_critic_params)):
        assert_module(mod, tree)
    np.testing.assert_allclose(ts.log_alpha.detach().numpy(), np.asarray(ts_j.log_alpha), rtol=1e-9, atol=1e-9)
    moved = not np.allclose(ts.log_alpha.detach().numpy(), np.log([0.1, 0.2, 0.35]), rtol=0, atol=0)
    assert moved == talgo.cfg.autotune_alpha
    assert ts.alpha_opt.count == (3 if talgo.cfg.autotune_alpha else 0)


@pytest.mark.parametrize("discrete", [False, True])
def test_explore_and_warmup_switch(discrete):
    """Past the warm-up, the policy's sample on JAX's draw (``fold_in(k_s,
    0)``) against JAX's explore_actions (1e-10); during it, uniform
    actions in ±high_action (one-hots when discrete) drawn from the
    generator alone."""
    B = 6
    jalgo, ts_j, talgo, ts = _pair(discrete=discrete, B=B, warmup_random_steps=64, high_action=0.5)
    obs = np.random.RandomState(3).uniform(-1.5, 1.5, (B, 3, 18))
    shape = (B, 3, talgo.act_dim)
    key = jax.random.PRNGKey(5)
    a_j = jax.jit(jalgo.explore_actions)(ts_j.replace(env_steps=jnp.asarray(64, jnp.int32)), jnp.asarray(obs), key)
    k_s, _ = jax.random.split(key)
    noise = (jgumbel if discrete else jnormal)(jax.random.fold_in(k_s, 0), shape)
    with torch.no_grad():
        a_t = talgo._explore(ts, t(obs), t(noise))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)

    g, ref = torch.Generator(), torch.Generator()
    g.manual_seed(9)
    ref.manual_seed(9)
    ts.env_steps = 63
    warm = talgo.explore_actions(ts, t(obs), g)
    if discrete:
        want = torch.nn.functional.one_hot(torch.randint(0, 5, shape[:2], generator=ref), 5).to(F64)
    else:
        want = torch.rand(shape, generator=ref, dtype=F64) - 0.5
    assert torch.equal(warm, want)
    ts.env_steps = 64
    after = talgo.explore_actions(ts, t(obs), g)
    with torch.no_grad():
        want = talgo._explore(ts, t(obs), talgo._noise(ref, shape))
    assert torch.equal(after, want)
    for a in (warm, after):
        if discrete:  # the straight-through sample: one-hots up to rounding
            torch.testing.assert_close(a.sum(-1), torch.ones(B, 3, dtype=F64))
        else:
            assert float(a.abs().max()) <= 0.5


def test_masac_runs_and_tunes_alpha():
    """JAX ``test_masac_runs_and_tunes_alpha``."""
    algo = MASAC(gt.make_env("formation_hd_env", num_agents=3),
                 MASACConfig(buffer_size=2048, steps_per_iter=8, updates_per_iter=4, batch_size=64,
                             warmup_random_steps=32), num_envs=8, device="cpu")
    g = torch.Generator()
    state = algo.init(g)
    for _ in range(3):
        *state, m = algo.train_step(*state, g)
    assert np.isfinite(float(m["critic_loss"]))
    assert float(m["alpha"]) != MASACConfig().init_alpha  # the temperature moved
    assert np.isfinite(float(m["entropy"]))


def test_masac_discrete_gumbel_sac():
    """JAX ``test_masac_discrete_gumbel_sac``."""
    algo = MASAC(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True),
                 MASACConfig(buffer_size=1024, steps_per_iter=16, updates_per_iter=4, batch_size=64,
                             warmup_random_steps=32), num_envs=8, device="cpu")
    assert algo.discrete and algo.target_entropy > 0
    g = torch.Generator()
    state = algo.init(g)
    for _ in range(3):
        *state, m = algo.train_step(*state, g)
    ts, obs = state[0], state[3]
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    assert float(m["alpha"]) != MASACConfig().init_alpha
    assert 0.0 < float(m["entropy"]) <= np.log(5) + 0.1
    ev = algo.eval_actions(ts, obs)
    assert ev.shape == (8, 3, 5)
    assert torch.equal(ev.sum(-1), torch.ones(8, 3)) and set(ev.unique().tolist()) == {0.0, 1.0}
    # the straight-through sample is y_hard + y - y: one-hots up to rounding
    ex = algo.explore_actions(ts, obs, g)
    torch.testing.assert_close(ex.sum(-1), torch.ones(8, 3))


def test_checkpoint_round_trip(tmp_path):
    """The whole tuple, the temperatures and their Adam included."""
    def make():
        return MASAC(gt.make_env("formation_hd_env", num_agents=3, episode_length=3),
                     MASACConfig(buffer_size=40, batch_size=8, steps_per_iter=3, updates_per_iter=2,
                                 warmup_random_steps=12, hidden=(16, 16)), num_envs=4, device="cpu")

    algo, state = checkpoint_round_trip(make, tmp_path)
    assert state[0].alpha_opt.count == 6
