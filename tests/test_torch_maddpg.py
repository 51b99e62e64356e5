"""The port's MADDPG, DDPG and prioritized replay against the JAX package's,
in float64 on the same parameters, batches and draws:

- ``_losses`` and every gradient leaf (1e-10): continuous, discrete (the
  actor loss's Gumbel noise from JAX's ``fold_in(noise_key, i)``), DDPG's
  local critics with the done mask, and PER importance weights;
- three ``_update_once`` calls: parameters, targets and losses (1e-9);
- the exploration on JAX's draws (Gaussian, OU, Gumbel), the decay and the
  OU reset;
- the collection replayed through JAX's ``env.step`` across episode ends;
- PER: priorities and weights on given indices, the sampling frequencies
  against ``p^α``;
- the JAX package's MADDPG and PER behaviour tests, ported, and a
  checkpoint round trip.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MADDPG as JMADDPG, MADDPGConfig as JMADDPGConfig
from gym_formation_tpu.algos.per import PrioritizedReplayBuffer as JPER, beta_schedule as jbeta
from gym_formation_tpu.models.networks import CentralizedQCritic, DeterministicActor, LogitsActor

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import (
    MADDPG, MADDPGConfig, PrioritizedReplayBuffer, ReplayBuffer, beta_schedule,
)
from gym_formation_tpu_torch.models.networks import (
    deterministic_actor_from_flax, q_critic_from_flax, stacked_actor_from_flax,
)
from _offpolicy import (
    F64, H, assert_ddpg_state, assert_round_trip, assert_trees, batch, checkpoint_round_trip, ddpg_pair, grads_tree,
    jbatch, jgumbel, jnormal, replay_collection, t, tbatch,
)

TOL = dict(rtol=1e-10, atol=1e-10)
CASES = {
    "continuous": dict(),
    "discrete": dict(discrete=True),
    "ddpg": dict(centralized=False, mask_done=True),
    "per_weights": dict(),
}


def _pair(**kw):
    return ddpg_pair(JMADDPG, JMADDPGConfig, MADDPG, MADDPGConfig, **kw)


def draws_of(noise_key, M, n, da, discrete):
    """The actor loss's Gumbel noise as JAX draws it: agent i's from
    ``fold_in(noise_key, i)``."""
    if not discrete:
        return {}
    g = np.stack([jgumbel(jax.random.fold_in(noise_key, i), (M, da)) for i in range(n)], 1)
    return {"gumbel": t(g)}


@pytest.mark.parametrize("net", ["deterministic_actor", "logits_actor", "critic", "local_critic"])
def test_converters_round_trip(net):
    """The stacked actors and critics of MADDPG and DDPG: a vmapped flax init
    through ``*_from_flax`` and back, exactly."""
    o, oa, ua = jnp.zeros((1, 18)), jnp.zeros((1, 54)), jnp.zeros((1, 6))
    if net == "deterministic_actor":
        assert_round_trip(DeterministicActor(2, 0.5, H), (o,), deterministic_actor_from_flax, max_action=0.5)
    elif net == "logits_actor":
        assert_round_trip(LogitsActor(5, H), (o,), stacked_actor_from_flax)
    elif net == "critic":
        assert_round_trip(CentralizedQCritic(0.5, H), (oa, ua), q_critic_from_flax, max_action=0.5)
    else:
        assert_round_trip(CentralizedQCritic(1.0, H), (o, ua[:, :2]), q_critic_from_flax)


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_grads_match_jax(case):
    kw = CASES[case]
    jalgo, ts_j, talgo, ts = _pair(**kw)
    M, da = 12, talgo.act_dim
    b = batch(1, M, 3, 18, da, talgo.discrete)
    nk = jax.random.PRNGKey(7)
    w = np.random.RandomState(2).uniform(0.2, 1.0, M) if case == "per_weights" else None
    jw = None if w is None else jnp.asarray(w)

    def loss(p):
        return jalgo._losses(p["actor"], p["critic"], ts_j, dict(jbatch(b), noise_key=nk), jw)

    (total_j, aux_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {"actor": ts_j.actor_params, "critic": ts_j.critic_params})
    c_l, a_l, td = talgo._losses(ts, tbatch(b), draws_of(nk, M, 3, da, talgo.discrete), None if w is None else t(w))
    np.testing.assert_allclose(float((c_l.sum() + a_l.sum()).detach()), float(total_j), **TOL)
    np.testing.assert_allclose(float(c_l.detach().mean()), float(aux_j["critic_loss"]), **TOL)
    np.testing.assert_allclose(float(a_l.detach().mean()), float(aux_j["actor_loss"]), **TOL)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(aux_j["td_abs"]), **TOL)
    g_a = torch.autograd.grad(a_l.sum(), list(ts.actor.parameters()))
    g_c = torch.autograd.grad(c_l.sum(), list(ts.critic.parameters()))
    assert_trees({"actor": grads_tree(ts.actor, g_a), "critic": grads_tree(ts.critic, g_c)}, g_j, 1e-10, 1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_update_once_matches_jax(case):
    """Three updates on three batches: every network and target, the
    losses and the per-sample |TD| (1e-9)."""
    kw = CASES[case]
    jalgo, ts_j, talgo, ts = _pair(**kw)
    M, da = 10, talgo.act_dim
    update = jax.jit(jalgo._update_once)
    for k in range(3):
        b = batch(10 + k, M, 3, 18, da, talgo.discrete)
        nk = jax.random.PRNGKey(20 + k)
        w = np.random.RandomState(k).uniform(0.2, 1.0, M) if case == "per_weights" else None
        ts_j, aux_j = update(ts_j, dict(jbatch(b), noise_key=nk), None if w is None else jnp.asarray(w))
        aux_t = talgo._update_once(ts, tbatch(b), draws_of(nk, M, 3, da, talgo.discrete),
                                   None if w is None else t(w))
        for key in aux_j:
            np.testing.assert_allclose(np.asarray(aux_t[key]), np.asarray(aux_j[key]), rtol=1e-9, atol=1e-9,
                                       err_msg=key)
    assert_ddpg_state(ts, ts_j)
    assert ts.grad_updates == int(ts_j.grad_updates) == 3
    assert ts.actor_opt.count == ts.critic_opt.count == 3


@pytest.mark.parametrize("mode", ["gaussian", "ou", "discrete"])
def test_explore_matches_jax(mode):
    """JAX's explore_actions and the port's _explore on the draws JAX makes
    from the same key: actions and the advanced OU state (1e-10); the
    actions inside ±high_action, or one-hots."""
    B = 8
    jalgo, ts_j, talgo, ts = _pair(discrete=mode == "discrete", ou_noise=mode == "ou", B=B, epsilon=0.5,
                                   noise_rate=0.75, high_action=0.5)
    rng = np.random.RandomState(4)
    obs = rng.uniform(-1.5, 1.5, (B, 3, 18))
    shape = (B, 3, talgo.act_dim)
    ou0 = rng.normal(size=shape) * 0.3
    ts_j = ts_j.replace(ou_state=jnp.asarray(ou0))
    ts.ou_state = t(ou0)
    key = jax.random.PRNGKey(5)
    a_j, ts_j2 = jax.jit(jalgo.explore_actions)(ts_j, jnp.asarray(obs), key)
    k_eps, k_uni, k_noise = jax.random.split(key, 3)
    if mode == "discrete":
        draws = {"gumbel": jgumbel(k_noise, shape)}
    else:
        draws = {"normal": jnormal(k_noise, shape),
                 "uniform": np.asarray(jax.random.uniform(k_uni, shape, jnp.float64, -0.5, 0.5)),
                 "take": np.asarray(jax.random.uniform(k_eps, (B, 3, 1), jnp.float64))}
    with torch.no_grad():
        a_t = talgo._explore(ts, t(obs), {k: t(v) for k, v in draws.items()})
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(ts.ou_state.numpy(), np.asarray(ts_j2.ou_state), **TOL)
    if mode == "discrete":
        assert torch.equal(a_t.sum(-1), torch.ones(B, 3, dtype=F64)) and set(a_t.unique().tolist()) == {0.0, 1.0}
    else:
        assert float(a_t.abs().max()) <= 0.5
        take = draws["take"][..., 0] < 0.5
        assert take.any() and (~take).any()  # both branches of the ε-greedy
        if mode == "ou":
            assert not np.allclose(ts.ou_state.numpy(), ou0)
    a_g = talgo.explore_actions(ts, t(obs), torch.Generator())
    assert a_g.shape == shape and float(a_g.abs().max()) <= (1.0 if mode == "discrete" else 0.5)


def test_decay_and_ou_reset():
    """Per env step: noise and ε fall by explore_decay · B (the JAX
    package's float32 arithmetic) to explore_min; the OU state returns to
    ou_mu in the envs whose episode ended."""
    B = 4
    algo = MADDPG(gt.make_env("formation_hd_env", num_agents=3),
                  MADDPGConfig(ou_noise=True, ou_mu=0.1, explore_decay=0.02, buffer_size=8), num_envs=B,
                  device="cpu", dtype=F64)
    g = torch.Generator()
    ts = algo.init(g)[0]
    ou = torch.randn(B, 3, 2, dtype=F64, generator=g)
    ts.ou_state = ou.clone()
    done = torch.tensor([True, False, True, False])[:, None].expand(B, 3)
    noise, eps = np.float32(0.25), np.float32(0.1)
    for _ in range(3):
        algo._after_env_step(ts, SimpleNamespace(done=done))
        noise = np.maximum(np.float32(0.05), noise - np.float32(0.02 * B))
        eps = np.maximum(np.float32(0.05), eps - np.float32(0.02 * B))
        np.testing.assert_allclose(ts.noise, noise, rtol=1e-6)
        np.testing.assert_allclose(ts.epsilon, eps, rtol=1e-6)
    assert ts.noise == ts.epsilon == 0.05
    assert torch.all(ts.ou_state[done[:, 0]] == 0.1) and torch.equal(ts.ou_state[~done[:, 0]], ou[~done[:, 0]])


@pytest.mark.parametrize("discrete", [False, True])
def test_collection_replays_in_jax(discrete):
    """5 env steps with episodes of 3 (every env ends one), continuous and
    discrete: the buffer's rows against JAX's env.step on the port's
    pre-step states and actions (ports ``test_offpolicy_terminal_next_obs_
    not_reset_obs``)."""
    B, ep = 4, 3
    jenv = ft.FormationEnv(ft.make_scenario("formation_hd_env", num_agents=3, episode_length=ep),
                           discrete_action=discrete)
    algo = MADDPG(gt.make_env("formation_hd_env", num_agents=3, episode_length=ep, discrete_action=discrete),
                  MADDPGConfig(steps_per_iter=5, buffer_size=64, hidden=(16, 16)), num_envs=B, device="cpu",
                  dtype=F64)
    ts = algo.init(torch.Generator())[0]
    buf = replay_collection(algo, jenv, ts, 5, B, 3, ep)
    if discrete:
        a = buf.action[:buf.size]
        assert torch.equal(a.sum(-1), torch.ones(a.shape[:2], dtype=F64))
    assert ts.env_steps == 5 * B


# -- prioritized replay --------------------------------------------------------

def test_per_priorities_and_weights_match_jax():
    """Inserts across the ring's end, priority updates on distinct indices
    and the importance weights of JAX's sampled indices (1e-10); the
    gathered rows; beta_schedule."""
    cap, rng = 32, np.random.RandomState(0)
    jb, tb = JPER.create(cap, 3, 4, 2), PrioritizedReplayBuffer(cap, 3, 4, 2, dtype=F64)

    def insert(n):
        nonlocal jb
        rows = (rng.normal(size=(n, 3, 4)), rng.normal(size=(n, 3, 2)), rng.normal(size=(n, 3)),
                rng.normal(size=(n, 3, 4)), rng.uniform(size=n) < 0.3)
        jb = jb.insert(*map(jnp.asarray, rows))
        tb.insert(*(torch.as_tensor(x) for x in rows))

    def update(idx, td):
        nonlocal jb
        jb = jb.update_priorities(jnp.asarray(idx), jnp.asarray(td))
        tb.update_priorities(torch.as_tensor(idx), t(td))

    insert(20)
    update(rng.permutation(20)[:12], rng.uniform(0.0, 3.0, 12))
    insert(20)  # wraps: the new slots get the running maximum
    update(rng.permutation(32)[:9], rng.uniform(0.0, 5.0, 9))
    assert (tb.ptr, tb.size) == (int(jb.ptr), int(jb.size)) == (8, 32)
    np.testing.assert_allclose(tb.priority.numpy(), np.asarray(jb.priority), rtol=1e-12, atol=0)
    np.testing.assert_allclose(float(tb.max_priority), float(jb.max_priority), rtol=1e-12)
    for alpha, beta in ((0.6, 0.4), (1.0, 0.85)):
        bj, idx, w = jb.sample_prioritized(jax.random.PRNGKey(3), 16, alpha, jnp.asarray(beta))
        idx_t = torch.as_tensor(np.array(idx))
        np.testing.assert_allclose(tb.weights(idx_t, alpha, beta).numpy(), np.asarray(w), **TOL)
        for k, v in tb.gather(idx_t).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(bj[k]), err_msg=k)
    for step in (0, 12_345, 100_000, 10 ** 7):
        np.testing.assert_allclose(beta_schedule(step), float(jbeta(jnp.asarray(step))), rtol=1e-12)


def test_per_sampling_frequencies():
    """400,000 draws from 12 filled slots of 16 against p^α / Σ p^α: each
    frequency within 5 standard errors; the empty slots never drawn."""
    tb = PrioritizedReplayBuffer(16, 1, 1, 1, dtype=F64)
    z = torch.zeros(12, 1, 1, dtype=F64)
    tb.insert(z, z, z[..., 0], z, torch.zeros(12, dtype=torch.bool))
    p = np.random.RandomState(1).uniform(0.1, 5.0, 12)
    tb.update_priorities(torch.arange(12), t(p - 1e-6))
    g = torch.Generator()
    g.manual_seed(0)
    n = 400_000
    _, idx, w = tb.sample_prioritized(g, n, 0.6, 0.4)
    freq = np.bincount(idx.numpy(), minlength=16) / n
    want = p ** 0.6 / (p ** 0.6).sum()
    se = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(freq[:12] - want) < 5 * se), (freq[:12], want)
    assert not freq[12:].any()
    assert float(w.max()) == 1.0 and float(w.min()) > 0


def test_per_buffer_and_maddpg_integration():
    """JAX ``test_per_buffer_and_maddpg_integration``."""
    buf = PrioritizedReplayBuffer(32, 3, 4, 2)
    obs = torch.ones(8, 3, 4)
    buf.insert(obs, torch.zeros(8, 3, 2), torch.ones(8, 3), obs, torch.zeros(8, dtype=torch.bool))
    g = torch.Generator()
    batch_, idx, w = buf.sample_prioritized(g, 16, alpha=0.6, beta=0.4)
    assert batch_["obs"].shape == (16, 3, 4)
    assert float(w.max()) == 1.0 and float(w.min()) > 0
    buf.update_priorities(torch.tensor([3]), torch.tensor([1000.0]))
    _, idx2, _ = buf.sample_prioritized(g, 64, alpha=1.0, beta=1.0)
    assert int((idx2 == 3).sum()) > 32  # the hot index takes most draws
    assert beta_schedule(0) == 0.4 and beta_schedule(10 ** 9) == 1.0

    algo = MADDPG(gt.make_env("formation_hd_env", num_agents=3),
                  MADDPGConfig(use_per=True, buffer_size=1024, steps_per_iter=8, updates_per_iter=2, batch_size=64),
                  num_envs=8, device="cpu")
    state = algo.init(torch.Generator())
    for _ in range(2):
        *state, m = algo.train_step(*state, g)
    assert np.isfinite(float(m["critic_loss"]))
    pr = state[1].priority.numpy()
    assert len(np.unique(pr[pr > 0])) > 10  # priorities were TD-updated


# -- the JAX package's behaviour tests, ported -----------------------------------

def test_replay_buffer_ring_and_sample():
    buf = ReplayBuffer(10, 3, 4, 2)
    obs = torch.arange(6 * 3 * 4, dtype=torch.float32).reshape(6, 3, 4)
    act, rew, done = torch.zeros(6, 3, 2), torch.ones(6, 3), torch.zeros(6, dtype=torch.bool)
    buf.insert(obs, act, rew, obs, done)
    assert (buf.size, buf.ptr) == (6, 6)
    buf.insert(obs, act, rew, obs, done)  # wraps: 12 > 10
    assert (buf.size, buf.ptr) == (10, 2)
    assert torch.equal(buf.obs[:2], obs[4:]) and torch.equal(buf.obs[6:], obs[:4])
    assert buf.sample(torch.Generator(), 4)["obs"].shape == (4, 3, 4)


def test_maddpg_train_step_runs():
    algo = MADDPG(gt.make_env("formation_hd_env", num_agents=3),
                  MADDPGConfig(buffer_size=4096, steps_per_iter=4, updates_per_iter=2, batch_size=64), num_envs=8,
                  device="cpu")
    g = torch.Generator()
    ts, buf, es, obs = algo.init(g)
    # 4 steps × 8 envs = 32 transitions < batch 64: the updates wait
    ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, g)
    assert float(m["critic_loss"]) == 0.0 and m["buffer_size"] == 32
    ts, buf, es, obs, m = algo.train_step(ts, buf, es, obs, g)
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    assert ts.noise < MADDPGConfig().noise_rate  # the decay acted
    acts = algo.eval_actions(ts, obs)
    assert acts.shape == (8, 3, 2) and float(acts.abs().max()) <= 1.0


def test_maddpg_per_agent_params_differ():
    algo = MADDPG(gt.make_env("formation_hd_env", num_agents=3), num_envs=4, device="cpu")
    ts = algo.init(torch.Generator())[0]
    kernels = [p for name, p in ts.actor.named_parameters() if name.endswith("kernel")]
    assert kernels and all(k.shape[0] == 3 for k in kernels)
    assert not torch.allclose(kernels[0][0], kernels[0][1])


def test_ddpg_local_critic_mode():
    algo = MADDPG(gt.make_env("formation_hd_env", num_agents=3),
                  MADDPGConfig(centralized=False, buffer_size=2048, steps_per_iter=8, updates_per_iter=2,
                               batch_size=64), num_envs=8, device="cpu")
    g = torch.Generator()
    state = algo.init(g)
    for _ in range(3):
        *state, m = algo.train_step(*state, g)
    in_dims = {p.shape[-2] for name, p in state[0].critic.named_parameters() if name.endswith("kernel")}
    assert 18 + 2 in in_dims  # one agent's obs + act
    assert 3 * (18 + 2) not in in_dims


def test_maddpg_discrete_gumbel_path():
    algo = MADDPG(gt.make_env("formation_hd_env", num_agents=3, discrete_action=True),
                  MADDPGConfig(buffer_size=1024, steps_per_iter=16, updates_per_iter=2, batch_size=64), num_envs=8,
                  device="cpu")
    assert algo.discrete and algo.act_dim == 5
    g = torch.Generator()
    ts, buf, es, obs, m = algo.train_step(*algo.init(g), g)
    assert np.isfinite(float(m["critic_loss"])) and float(m["critic_loss"]) > 0
    for a in (algo.explore_actions(ts, obs, g), algo.eval_actions(ts, obs)):
        assert a.shape == (8, 3, 5)
        assert torch.equal(a.sum(-1), torch.ones(8, 3)) and set(a.unique().tolist()) == {0.0, 1.0}


def test_checkpoint_round_trip(tmp_path):
    """MADDPG with PER and OU noise: the whole tuple, the priorities and the
    OU state included."""
    def make():
        return MADDPG(gt.make_env("formation_hd_env", num_agents=3, episode_length=3),
                      MADDPGConfig(use_per=True, ou_noise=True, buffer_size=40, batch_size=8, steps_per_iter=3,
                                   updates_per_iter=2, hidden=(16, 16)), num_envs=4, device="cpu")

    algo, state = checkpoint_round_trip(make, tmp_path)
    assert state[1].size == 36 and state[0].grad_updates == 6
