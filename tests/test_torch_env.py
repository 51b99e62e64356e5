"""The port's formation_hd env, scripted policy and BFS expansion, held
against the JAX package on the same numpy inputs — up to the whole step
slice: the same injected state stepped under the BFS controller by both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.core.types import EnvState as JEnvState

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.models import scripted as tscripted
from gym_formation_tpu_torch.ops.kernels import pairforce_sym, reward_sym


def _state_np(n, B, seed, episode_t=0):
    """A batched formation_hd state made with numpy: agents and landmarks
    in [−1, 1], landmarks recentred onto the agents' centroid."""
    rng = np.random.RandomState(seed)
    apos = rng.uniform(-1, 1, (B, n, 2))
    lpos = rng.uniform(-1, 1, (B, n, 2))
    ishape = lpos - lpos.mean(1, keepdims=True)
    lpos = ishape + apos.mean(1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        pos=f32(np.concatenate([apos, lpos], 1)),
        vel=f32(rng.uniform(-0.3, 0.3, (B, 2 * n, 2)) * np.r_[np.ones(n), np.zeros(n)][None, :, None]),
        c=np.zeros((B, n, 2), np.float32),
        ideal_shape=f32(ishape),
        ideal_vel=f32(rng.uniform(-1, 1, (B, 2))),
        t=np.full(B, episode_t, np.int32),
    )


def _jax_state(st):
    B = st["pos"].shape[0]
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    return JEnvState(**{k: jnp.asarray(v) for k, v in st.items()}, key=keys)


@pytest.mark.parametrize("layer", [0, 1, 2, 3])
@pytest.mark.parametrize("fix_recursion", [False, True])
def test_generate_shape_matches_jax(layer, fix_recursion):
    custom = np.random.RandomState(layer).uniform(-1, 1, (4, 3, 2))
    for shapes in (None, custom):
        want = ft.generate_shape(layer, shapes, fix_recursion=fix_recursion)
        got = gt.generate_shape(layer, shapes, fix_recursion=fix_recursion)
        np.testing.assert_array_equal(got, want)
    # the quirk: custom shapes reach only the top layer unless fixed
    if layer > 0:
        quirk = gt.generate_shape(layer, custom)
        fixed = gt.generate_shape(layer, custom, fix_recursion=True)
        assert not np.allclose(quirk, fixed)


def test_observe_and_pre_obs_match_jax():
    n, B = 9, 3
    st = _state_np(n, B, 1)
    st["pos"][:, n:] += 0.25  # pre_obs must recentre the landmarks again
    st["c"] = np.random.RandomState(2).uniform(-1, 1, (B, n, 2)).astype(np.float32)
    jscen = ft.make_env("formation_hd_env", num_agents=n).scenario
    tscen = gt.make_env("formation_hd_env", num_agents=n).scenario
    jst = jax.vmap(jscen.pre_obs)(_jax_state(st))
    want = np.asarray(jax.vmap(jscen.observe)(jst))
    tst = tscen.pre_obs(gt.state_from_numpy(st))
    got = tscen.observe(tst).numpy()
    assert got.shape == (B, n, 6 * n)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos), atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _ez_obs(n, other_pos, shape, ivel):
    return np.concatenate([np.zeros(2), np.ravel(other_pos), np.zeros(2 * n - 2),
                           np.ravel(shape), ivel])


def test_ezpolicy_matches_jax_with_ties():
    """Random rows plus rows built for exact ties: every agent on one point
    (argmin ties → first index) and a shape equidistant from self
    (fallback → farthest vertex, highest index among ties)."""
    n = 4
    square = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    rows = [
        _ez_obs(n, np.zeros((3, 2)), square, [0.5, -0.25]),
        _ez_obs(n, square[:3] - square[3], square, [0.0, 0.0]),
        _ez_obs(n, square[1:] * 0.5, square * 0.5, [1.0, 1.0]),
        _ez_obs(n, np.zeros((3, 2)), np.zeros((4, 2)), [0.25, 0.0]),  # settled
    ]
    rng = np.random.RandomState(3)
    rows += [_ez_obs(n, rng.uniform(-1, 1, (3, 2)), rng.uniform(-1, 1, (4, 2)),
                     rng.uniform(-1, 1, 2)) for _ in range(60)]
    obs = np.stack(rows)
    want = np.asarray(jax.vmap(lambda o: ft.ezpolicy(o, n))(jnp.asarray(obs)))
    got = tscripted.ezpolicy(torch.as_tensor(obs), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_per_layer,layers", [(3, 2), (2, 3), (3, 3)])
def test_bfs_actions_match_jax_and_state_path(n_per_layer, layers):
    n = n_per_layer**layers
    B = 2
    st = {k: v.astype(np.float64) if v.dtype == np.float32 else v
          for k, v in _state_np(n, B, n).items()}
    jenv = ft.make_env("formation_hd_env", num_agents=n)
    tenv = gt.make_env("formation_hd_env", num_agents=n)
    jobs = jax.vmap(jenv.scenario.observe)(_jax_state(st))
    want = np.asarray(jax.jit(
        lambda o: ft.bfs_actions_batched(ft.ezpolicy_batched, o, n_per_layer))(jobs))
    tst = gt.state_from_numpy(st, dtype=torch.float64)
    tobs = tenv.scenario.observe(tst)
    got = gt.bfs_actions(gt.ezpolicy_batched, tobs, n_per_layer).numpy()
    from_state = gt.bfs_actions_from_state(gt.ezpolicy_batched, tenv.scenario, tst, n_per_layer)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(from_state.numpy(), got, rtol=1e-9, atol=1e-9)


def _slice_both(n, B, T, seed):
    """Step the same state T steps under the BFS controller in both
    packages; returns (jax final state, jax rewards [B, T, N], port state,
    port rewards [T, B, N])."""
    st = _state_np(n, B, seed)
    jenv = ft.make_env("formation_hd_env", num_agents=n)
    jpol = lambda s, k: ft.bfs_actions_from_state(ft.ezpolicy_batched, jenv.scenario, s, 3)
    jfinal, jrew = jax.jit(jax.vmap(
        lambda s, k: ft.rollout_statepolicy(jenv, jpol, s, k, T)))(
        _jax_state(st), jax.random.split(jax.random.PRNGKey(1), B))
    venv = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, device="cpu")
    tpol = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, venv.env.scenario, s, 3)
    tfinal, trew = gt.rollout_statepolicy(venv.env, tpol, gt.state_from_numpy(st), venv.generator, T)
    return jfinal, np.asarray(jrew), tfinal, trew.numpy()


@pytest.mark.parametrize("n,B,T", [(27, 3, 8), (243, 2, 2)])
def test_slice_matches_jax(n, B, T):
    """The step slice: BFS + ezpolicy actions, physics with contacts, the
    hd reward and the shared-reward broadcast.  Tolerances are those of
    tests/test_fused_step.py; T stays ≤ 10 because f32 contact trajectories
    diverge beyond that."""
    jfinal, jrew, tfinal, trew = _slice_both(n, B, T, seed=n)
    np.testing.assert_allclose(tfinal.pos.numpy(), np.asarray(jfinal.pos), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(tfinal.t.numpy(), np.asarray(jfinal.t))
    np.testing.assert_allclose(trew, jrew.transpose(1, 0, 2), atol=1e-4, rtol=1e-5)


def test_auto_reset():
    """``done`` at t == world_length; the same step hands back t = 0 and a
    fresh episode: positions in [−1, 1], a centred ideal shape, landmarks
    recentred on the agents; the obs of a done env is the fresh one's."""
    n, B, L = 9, 4, 3
    venv = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, episode_length=L, seed=7, device="cpu")
    state, obs = venv.reset()
    state.t[:2] = 1  # two envs one step ahead: only they end at the last step
    acts = torch.zeros(B, n, 2)
    for step in range(1, L):
        old = state
        state, out = venv.step(state, acts)
        ended = out.done[:, 0]
        expect = torch.tensor([True, True, False, False]) if step == L - 1 else torch.zeros(B, dtype=torch.bool)
        assert torch.equal(ended, expect)
        assert torch.equal(out.done, ended[:, None].expand(B, n))
    assert state.t.tolist() == [0, 0, L - 1, L - 1]
    fresh = slice(0, 2)
    sc = venv.env.scenario
    assert sc.agent_pos(state)[fresh].abs().max() <= 1.0
    assert torch.all(state.vel[fresh] == 0)
    np.testing.assert_allclose(state.ideal_shape[fresh].mean(1).numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(sc.landmark_pos(state).mean(1).numpy(),
                               sc.agent_pos(state).mean(1).numpy(), atol=1e-5)
    assert not torch.equal(state.ideal_shape[fresh], old.ideal_shape[fresh])
    assert torch.equal(state.ideal_shape[2:], old.ideal_shape[2:])
    np.testing.assert_allclose(out.obs.numpy(), sc.observe(state).numpy(), atol=1e-6)
    assert not torch.equal(out.info["terminal_obs"][fresh], out.obs[fresh])


def test_shared_reward_and_rewardsum():
    n, B, T = 9, 3, 4
    venv = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, seed=3, device="cpu")
    state, _ = venv.reset()
    pol = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, venv.env.scenario, s, 3)
    g0 = venv.generator.get_state()
    _, rew = gt.rollout_statepolicy(venv.env, pol, state, venv.generator, T)
    venv.generator.set_state(g0)
    _, rsum = gt.rollout_statepolicy_rewardsum(venv.env, pol, state, venv.generator, T)
    assert torch.all(rew == rew[..., :1])  # the shared sum, broadcast
    np.testing.assert_allclose(rsum.numpy(), rew.sum((0, 2)).numpy(), rtol=1e-6)


def test_obs_rollout_matches_state_rollout():
    """rollout (policy on the [B, N, 6N] obs) and rollout_statepolicy give
    the same rewards: the BFS expansion reads the same quantities from both."""
    n, B, T = 9, 2, 3
    venv = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, seed=4, device="cpu")
    state, obs = venv.reset()
    g0 = venv.generator.get_state()
    (_, last_obs), outs = gt.rollout(
        venv.env, lambda o, g: gt.bfs_actions(gt.ezpolicy_batched, o, 3), state, obs, venv.generator, T)
    venv.generator.set_state(g0)
    final, rew = gt.rollout_statepolicy(
        venv.env, lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, venv.env.scenario, s, 3),
        state, venv.generator, T)
    assert outs.obs.shape == (T, B, n, 6 * n)
    np.testing.assert_allclose(outs.reward.numpy(), rew.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(last_obs.numpy(), venv.env.scenario.observe(final).numpy(), atol=1e-6)


def test_benchmark_quartet_matches_jax():
    n, B = 9, 2
    st = _state_np(n, B, 6)
    st["pos"][:, :n] *= 0.05  # collisions and occupied landmarks present
    jscen = ft.make_env("formation_hd_env", num_agents=n).scenario
    want = jax.vmap(jscen.benchmark)(_jax_state(st))
    tenv = gt.make_env("formation_hd_env", num_agents=n, benchmark=True)
    got = tenv.scenario.benchmark(gt.state_from_numpy(st))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="generator"):
        tenv.step_state(gt.state_from_numpy(st), torch.zeros(B, n, 2))
    _, out = tenv.step_state(gt.state_from_numpy(st), torch.zeros(B, n, 2), torch.Generator())
    assert {"collisions", "min_dists", "occupied_landmarks"} <= set(out.info)


def test_cpu_run_launches_no_kernel():
    before = (pairforce_sym.launches, reward_sym.launches)
    venv = gt.make_vec_env("formation_hd_env", num_envs=2, num_agents=9, device="cpu")
    state, _ = venv.reset()
    venv.step_state(state, venv.sample_actions())
    assert (pairforce_sym.launches, reward_sym.launches) == before


def test_registry_and_spaces():
    env = gt.make_env("formation_hd_env", num_agents=9)
    assert len(env.action_space) == 9 and env.action_space[0].shape == (2,)
    assert env.observation_space[0].shape == (54,)
    assert env.share_observation_space[0].shape == (54 * 9,)
    # every scenario of the JAX package builds and steps; make_env() with no
    # arguments builds basic_formation_env, as the JAX package's does
    for env in (gt.make_env(), gt.make_env("basic_formation_env")):
        assert env.scenario.name == "basic_formation_env"
        state, obs = env.reset(torch.Generator(), 2)
        _, out = env.step(state, env.sample_actions(torch.Generator(), 2), torch.Generator())
        assert obs.shape == (2, 3, 18) and torch.isfinite(out.reward).all()
    five = {"basic_formation_env", "formation_hd_env", "formation_hd_obs_env",
            "formation_hd_partial_env", "formation_hd_partial_range_env"}
    assert five <= set(ft.SCENARIOS) and five <= set(gt.SCENARIOS)
    with pytest.raises(ValueError, match="Unknown"):
        gt.make_env("no_such_env")
    discrete = gt.make_env("formation_hd_env", discrete_action=True)
    assert discrete.act_dim == 5 and repr(discrete.action_space[0]) == "Discrete(5)"


def test_state_carry_over_roundtrip():
    st = _state_np(9, 2, 5)
    back = gt.state_to_numpy(gt.state_from_numpy(_jax_state(st)))
    for k, v in st.items():
        np.testing.assert_array_equal(back[k], v)
