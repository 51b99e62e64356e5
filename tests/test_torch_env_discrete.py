"""The port's discrete action surface and the rest of the env surface,
held against the JAX package on the same numpy states and actions in
float64: the three discrete decodings, ``act_dim`` and the spaces (with
silent and speaking agents), the ``scripted_mask`` hook,
``rollout_stateonly`` and ``VecFormationEnv.reset_choose``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.core.types import EnvState as JEnvState

import gym_formation_tpu_torch as gt

F64 = torch.float64
DECODINGS = ("discrete_action", "discrete_action_input", "force_discrete_action")


def _state_np(n, B, seed):
    rng = np.random.RandomState(seed)
    apos = rng.uniform(-1, 1, (B, n, 2))
    ishape = rng.uniform(-1, 1, (B, n, 2))
    ishape -= ishape.mean(1, keepdims=True)
    return dict(
        pos=np.concatenate([apos, ishape + apos.mean(1, keepdims=True)], 1),
        vel=np.concatenate([rng.uniform(-0.3, 0.3, (B, n, 2)), np.zeros((B, n, 2))], 1),
        c=np.zeros((B, n, 2)), ideal_shape=ishape, ideal_vel=rng.uniform(-1, 1, (B, 2)),
        t=np.zeros(B, np.int32),
    )


def _jstate(st):
    keys = jax.random.split(jax.random.PRNGKey(0), st["pos"].shape[0])
    return JEnvState(**{k: jnp.asarray(v) for k, v in st.items()}, key=keys)


def _speaking(scen):
    """The scenario with every agent speaking (non-silent), as both packages'
    spaces and comm decodings read ``cfg.silent``."""
    scen.cfg = dataclasses.replace(scen.cfg, silent=np.zeros(scen.cfg.n_agents, bool))
    return scen


def _envs(flag, n=3, speaking=False, **kw):
    js = ft.make_scenario("formation_hd_env", num_agents=n, **kw)
    ts = gt.make_scenario("formation_hd_env", num_agents=n, **kw)
    if speaking:
        js, ts = _speaking(js), _speaking(ts)
    flags = {} if flag is None else {flag: True}
    return (ft.FormationEnv(js, auto_reset=False, **flags),
            gt.FormationEnv(ts, auto_reset=False, **flags))


def _actions(flag, env, B, n, seed):
    rng = np.random.RandomState(seed)
    if flag == "discrete_action_input":
        return rng.randint(0, 5, (B, n, 1))
    a = rng.uniform(-1, 1, (B, n, env.act_dim))
    if flag == "discrete_action":
        a[..., :5] = np.eye(5)[rng.randint(0, 5, (B, n))]  # one-hot moves, free comm
    return a


def _step_both(jenv, tenv, st, actions):
    js, jout = jax.vmap(jenv.step)(_jstate(st), jnp.asarray(actions))
    ts, tout = tenv.step(gt.state_from_numpy(st, dtype=F64), torch.as_tensor(actions))
    return (js, jout), (ts, tout)


@pytest.mark.parametrize("speaking", [False, True])
@pytest.mark.parametrize("flag", DECODINGS + (None,))
def test_decoding_matches_jax(flag, speaking):
    """One step from the same state under each decoding: the state (comm
    included) to 1e-12 in float64, act_dim and the spaces equal."""
    n, B = 3, 6
    jenv, tenv = _envs(flag, n, speaking)
    assert tenv.act_dim == jenv.act_dim
    assert [repr(s) for s in tenv.action_space] == [repr(s) for s in jenv.action_space]
    st = _state_np(n, B, 1)
    actions = _actions(flag, tenv, B, n, 2)
    (js, jout), (ts, tout) = _step_both(jenv, tenv, st, actions)
    for k in ("pos", "vel", "c"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=0, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward), rtol=0, atol=1e-12)
    if speaking and flag != "discrete_action_input":
        assert np.abs(np.asarray(js.c)).max() > 0  # the comm slice reached the state


def test_spaces_and_widths():
    _, t = _envs("discrete_action", speaking=True)
    assert t.act_dim == 7 and repr(t.action_space[0]) == "Tuple([Discrete(5), Discrete(2)])"
    _, t = _envs("discrete_action")
    assert t.act_dim == 5 and repr(t.action_space[0]) == "Discrete(5)"
    _, t = _envs("discrete_action_input")
    assert t.act_dim == 1
    _, t = _envs("force_discrete_action")
    assert t.act_dim == 2 and repr(t.action_space[0]) == "Box(2,)"


def test_index_input_sample_actions():
    """The index input's random actions are move indices 0..4, [B, N, 1],
    and step."""
    env = gt.make_env("formation_hd_env", num_agents=3, discrete_action_input=True)
    g = torch.Generator()
    g.manual_seed(0)
    a = env.sample_actions(g, 64)
    assert a.shape == (64, 3, 1) and set(a.unique().tolist()) == {0, 1, 2, 3, 4}
    state, _ = env.reset(g, 64)
    _, out = env.step(state, a, g)
    assert torch.isfinite(out.reward).all()


def _scripted(pkg, jax_side):
    class Scripted(pkg.SCENARIOS["formation_hd_env"]):
        scripted_mask = np.array([True, False, False])

        def scripted_actions(self, state):
            if jax_side:
                return jnp.tile(jnp.array([1.0, 0.0]), (3, 1))  # push +x
            return state.pos.new_tensor([1.0, 0.0]).expand(state.pos.shape[0], 3, 2)

    return Scripted(num_agents=3)


def test_scripted_agent_hook():
    """Scripted agents step their own control over the policy's: the same
    state and zero policy actions on both sides (1e-12), and the JAX test's
    claim (the scripted agent moves, the others do not)."""
    jenv = ft.FormationEnv(_scripted(ft, True), auto_reset=False)
    tenv = gt.FormationEnv(_scripted(gt, False), auto_reset=False)
    st = _state_np(3, 4, 3)
    st["vel"][:] = 0.0
    st["pos"][:, :3] = [[-0.8, 0.0], [0.0, 0.8], [0.8, -0.5]]  # apart: no contact force
    (js, _), (ts, _) = _step_both(jenv, tenv, st, np.zeros((4, 3, 2)))
    for k in ("pos", "vel"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=0, atol=1e-12)
    v = ts.vel.numpy()
    assert (v[:, 0, 0] >= 0.09).all()
    assert np.abs(v[:, 1:3]).max() < 1e-3


def _ez(obs, generator=None):
    return gt.ezpolicy_batched(obs.reshape(-1, obs.shape[-1])).reshape(obs.shape[:2] + (2,))


def test_rollout_stateonly_matches_rollout_and_jax():
    """rollout_stateonly under the ezpolicy gives rollout's rewards and
    final state exactly, and JAX's rollout_stateonly's over 8 steps (1e-12)."""
    n, B, T = 3, 5, 8
    env = gt.FormationEnv(gt.make_scenario("formation_hd_env", num_agents=n))
    st = _state_np(n, B, 4)
    g = torch.Generator()
    state = env.scenario.pre_obs(gt.state_from_numpy(st, dtype=F64))
    (s1, _), outs = gt.rollout(env, _ez, state, env.scenario.observe(state), g, T)
    s2, rewards = gt.rollout_stateonly(env, _ez, state, g, T)
    assert rewards.shape == (T, B, n)
    assert torch.equal(rewards, outs.reward) and torch.equal(s1.pos, s2.pos)

    jenv = ft.FormationEnv(ft.make_scenario("formation_hd_env", num_agents=n))
    jpolicy = lambda o, k: ft.ezpolicy_batched(o)
    one = lambda s: ft.rollout_stateonly(jenv, jpolicy, s, jax.random.PRNGKey(9), T)
    jstate, jrew = jax.vmap(one)(jax.vmap(jenv.scenario.pre_obs)(_jstate(st)))
    np.testing.assert_allclose(rewards.numpy(), np.asarray(jrew).swapaxes(0, 1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(s2.pos.numpy(), np.asarray(jstate.pos), rtol=0, atol=1e-12)


def test_reset_choose():
    """Unchosen envs keep their state and observation bit for bit; chosen
    ones get the generator's one draw of reset_state for the whole batch."""
    venv = gt.make_vec_env("formation_hd_env", num_envs=6, num_agents=3, device="cpu", seed=3)
    state, obs = venv.reset()
    state = state.replace(t=state.t + 7)
    choose = torch.tensor([True, False, False, True, False, True])
    before = venv.generator.get_state()
    new_state, new_obs = venv.reset_choose(state, obs, choose)
    g = torch.Generator()
    g.set_state(before)
    fresh = venv.env.reset_state(g, 6)
    fresh_obs = venv.env.scenario.observe(fresh)
    assert torch.equal(venv.generator.get_state(), g.get_state())
    for k in ("pos", "vel", "c", "ideal_shape", "ideal_vel", "t"):
        got, old, want = getattr(new_state, k), getattr(state, k), getattr(fresh, k)
        assert torch.equal(got[~choose], old[~choose]), k
        assert torch.equal(got[choose], want[choose]), k
    assert torch.equal(new_obs[~choose], obs[~choose]) and torch.equal(new_obs[choose], fresh_obs[choose])
