"""The port's scenarios (gym_formation_tpu_torch/envs/) and the kernel
selectors of its physics, held against the JAX package on the same numpy
inputs: each scenario's observation, reward and post-step in float64, the
hd_obs step slice in float32, and which kernel each selector routes to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.core.types import EnvState as JEnvState

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.core import physics as tphys
from gym_formation_tpu_torch.core import set_pallas_impl, set_reward_impl

from test_torch_physics import fake_card

NAMES = ("basic_formation_env", "formation_hd_env", "formation_hd_obs_env",
         "formation_hd_partial_env", "formation_hd_partial_range_env")


@pytest.fixture(autouse=True)
def _default_selectors():
    yield
    set_pallas_impl("auto")
    set_reward_impl("auto")


def _state_np(scen, B, seed, squeeze=1.0):
    """A batched state of ``scen`` made with numpy: agents squeezed by
    ``squeeze`` so that collisions fire; for hd_obs the obstacles among the
    agents, one of them below the floor of the driving law."""
    cfg, n = scen.cfg, scen.cfg.n_agents
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (B, cfg.n_entities, 2))
    pos[:, :n] *= squeeze
    if scen.name == "formation_hd_obs_env":
        t = scen.num_targets
        pos[:, n + t :] = pos[:, :3] + rng.uniform(-0.2, 0.2, (B, 3, 2))
        pos[:, -1, 1] = -2.5
    ishape = rng.uniform(-1, 1, (B, cfg.n_landmarks, 2))
    return dict(
        pos=pos,
        vel=rng.uniform(-0.5, 0.5, (B, cfg.n_entities, 2)),
        c=rng.uniform(-1, 1, (B, n, cfg.dim_c)),
        ideal_shape=ishape - ishape.mean(1, keepdims=True),
        ideal_vel=rng.uniform(-1, 1, (B, 2)),
        t=np.zeros(B, np.int32),
    )


def _jax_state(st):
    B = st["pos"].shape[0]
    return JEnvState(**{k: jnp.asarray(v) for k, v in st.items()},
                     key=jax.random.split(jax.random.PRNGKey(0), B))


@pytest.mark.parametrize("name", NAMES)
def test_obs_dims(name):
    """tests/test_scenarios.py:12-24 at N=3, through reset."""
    expected = {
        "basic_formation_env": 4 + 2 * 3 + 4 * 2,
        "formation_hd_env": 18,
        "formation_hd_obs_env": 2 + 2 * 7 + 4 * 2,
        "formation_hd_partial_env": 2 + 2 * 5 + 2 * 3 + 2 * 2,
        "formation_hd_partial_range_env": 2 + 2 * 4 + 4 * 2,
    }
    venv = gt.make_vec_env(name, num_envs=2, num_agents=3, device="cpu")
    _, obs = venv.reset()
    assert obs.shape == (2, 3, expected[name]) and venv.env.scenario.obs_dim == expected[name]
    assert torch.isfinite(obs).all()


@pytest.mark.parametrize("name", NAMES)
def test_scenario_functions_match_jax_f64(name):
    """pre_obs, observe, reward, post_step and the benchmark quartet on one
    injected state, in float64."""
    n, B = 6, 3
    jscen = ft.make_scenario(name, num_agents=n, dtype=jnp.float64)
    tscen = gt.make_scenario(name, num_agents=n, dtype=torch.float64)
    st = _state_np(tscen, B, 7, squeeze=0.15)
    jst = jax.vmap(jscen.pre_obs)(_jax_state(st))
    tst = tscen.pre_obs(gt.state_from_numpy(st, dtype=torch.float64))
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos), rtol=1e-10, atol=1e-10)
    got = (tscen.observe(tst), tscen.reward(tst), tscen.post_step(tst).vel)
    want = (jax.vmap(jscen.observe)(jst), jax.vmap(jscen.reward)(jst), jax.vmap(jscen.post_step)(jst).vel)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)
    assert np.asarray(want[1]).min() < -1.0  # collision terms present
    tb, jb = tscen.benchmark(tst), jax.vmap(jscen.benchmark)(jst)
    for k in jb:
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=1e-10, atol=1e-10, err_msg=k)


def test_hd_obs_post_step_driving_law():
    """Obstacles get velocity (0, −1) above y = −2.2 and stop below it;
    agents and targets keep theirs."""
    scen = gt.make_scenario("formation_hd_obs_env", num_agents=4)
    st = gt.state_from_numpy(_state_np(scen, 2, 3))
    out = scen.post_step(st)
    ovel = out.vel[:, 8:]
    assert torch.equal(ovel[:, :2], torch.tensor([0.0, -1.0]).expand(2, 2, 2))
    assert torch.equal(ovel[:, 2], torch.zeros(2, 2))
    assert torch.equal(out.vel[:, :8], st.vel[:, :8])


def test_obstacle_dynamics():
    """tests/test_scenarios.py:test_obstacle_dynamics: obstacles spawn in
    their bands and fall; static targets never move."""
    scen = gt.make_scenario("formation_hd_obs_env", num_agents=4)
    env = gt.FormationEnv(scen, auto_reset=False)
    g = torch.Generator()
    g.manual_seed(0)
    state, _ = env.reset(g, 2)
    o0 = state.pos[:, 8:].clone()  # 4 agents + 4 targets + 3 obstacles
    assert ((o0[..., 1] >= 2.0) & (o0[..., 1] <= 2.5)).all()
    band = torch.linspace(-1.8, 1.8, 4)
    assert ((o0[..., 0] >= band[:3]) & (o0[..., 0] <= band[1:])).all()
    assert torch.equal(state.vel[:, 8:], torch.tensor([0.0, -1.0]).expand(2, 3, 2))
    t0 = state.pos[:, 4:8].clone()
    zero = torch.zeros(2, 4, env.act_dim)
    for _ in range(30):
        state, _ = env.step(state, zero)
    assert (state.pos[:, 8:, 1] < o0[..., 1] - 1.0).all()
    assert torch.equal(state.pos[:, 4:8], t0)


def test_partial_ring_obs():
    """tests/test_scenarios.py:test_partial_ring_obs."""
    scen = gt.make_scenario("formation_hd_partial_env", num_agents=5)
    st = scen.zero_state(1, "cpu")
    st = st.replace(pos=torch.cat([torch.tensor([[[float(i), 0.0] for i in range(5)]]), torch.zeros(1, 5, 2)], 1))
    obs = scen.observe(st)[0]
    torch.testing.assert_close(obs[0, 12:18].reshape(3, 2), torch.tensor([[1.0, 0], [2, 0], [3, 0]]))
    torch.testing.assert_close(obs[4, 12:18].reshape(3, 2), torch.tensor([[-4.0, 0], [-3, 0], [-2, 0]]))


def test_partial_range_clipping():
    """tests/test_scenarios.py:test_partial_range_clipping."""
    scen = gt.make_scenario("formation_hd_partial_range_env", num_agents=4)
    apos = torch.tensor([[[0.0, 0.0], [5.0, 0.0], [0.0, 0.1], [-3.0, 0.0]]])
    st = scen.zero_state(1, "cpu").replace(pos=torch.cat([apos, torch.zeros(1, 4, 2)], 1))
    rel = scen.observe(st)[0, 0, 10:16].reshape(3, 2)
    torch.testing.assert_close(rel, torch.tensor([[0.7, 0.0], [0.0, 0.1], [-0.7, 0.0]]))


def test_basic_reward_counts_self_collision():
    """tests/test_scenarios.py:test_basic_reward_counts_self_collision: the
    original's collision loop does not exclude self, so each agent pays −1
    even alone."""
    scen = gt.make_scenario("basic_formation_env", num_agents=3)
    apos = torch.tensor([[[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]]])
    st = scen.zero_state(1, "cpu").replace(pos=torch.cat([apos, apos], 1))
    torch.testing.assert_close(scen.reward(st), torch.full((1, 3), -1.0))


def _linear_w(obs_dim, act_dim, seed):
    return np.random.RandomState(seed).normal(size=(obs_dim, act_dim)) / np.sqrt(obs_dim)


def test_hd_obs_slice_matches_jax():
    """The hd_obs step slice, N=27, B=3, T=8 within an episode: the linear
    policy clip(obs @ W, −1, 1) of bench.py, physics with the mixed-size
    contacts (K6's plain version here), the reward and the obstacle law, in
    float32 in both packages.  Tolerances of tests/test_torch_env.py."""
    n, B, T = 27, 3, 8
    jenv = ft.make_env("formation_hd_obs_env", num_agents=n)
    tenv = gt.make_env("formation_hd_obs_env", num_agents=n)
    st = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
          for k, v in _state_np(tenv.scenario, B, 11, squeeze=0.5).items()}
    W = _linear_w(tenv.scenario.obs_dim, tenv.act_dim, 7).astype(np.float32)

    jstate = _jax_state(st)
    jobs = jax.vmap(jenv.scenario.observe)(jax.vmap(jenv.scenario.pre_obs)(jstate))
    jstep = jax.jit(jax.vmap(jenv.step))
    jrews = []
    for _ in range(T):
        jstate, jout = jstep(jstate, jnp.clip(jobs @ jnp.asarray(W), -1.0, 1.0))
        jobs = jout.obs
        jrews.append(np.asarray(jout.reward))

    g = torch.Generator()
    tstate = tenv.scenario.pre_obs(gt.state_from_numpy(st))
    tobs = tenv.scenario.observe(tstate)
    trews = []
    for _ in range(T):
        tstate, tout = tenv.step(tstate, torch.clamp(tobs @ torch.as_tensor(W), -1.0, 1.0), g)
        tobs = tout.obs
        trews.append(tout.reward.numpy())

    np.testing.assert_allclose(tstate.pos.numpy(), np.asarray(jstate.pos), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(tstate.vel.numpy(), np.asarray(jstate.vel), atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(tstate.t.numpy(), np.asarray(jstate.t))
    np.testing.assert_allclose(np.stack(trews), np.stack(jrews), atol=1e-4, rtol=1e-5)
    assert np.stack(jrews).min() < -2.0  # collision terms present


# -- selectors ---------------------------------------------------------------

def test_selector_names():
    for bad in ("on", "triangle"):
        with pytest.raises(ValueError):
            set_pallas_impl(bad)
        with pytest.raises(ValueError):
            set_reward_impl(bad)


def test_rowmajor_reward_equals_default():
    """set_reward_impl("rowmajor") routes the hd reward through K7's plain
    version: the same rewards as K2's, collisions included."""
    n, B = 27, 3
    scen = gt.make_scenario("formation_hd_env", num_agents=n)
    st = gt.state_from_numpy(_state_np(scen, B, 5, squeeze=0.05))
    want = scen.reward(st)
    set_reward_impl("rowmajor")
    got = scen.reward(st)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert want.min() < -1.0


def test_forced_sym_raises_off_its_envelope():
    obs = gt.make_scenario("formation_hd_obs_env", num_agents=9)
    pos = torch.zeros(1, obs.cfg.n_entities, 2)
    set_pallas_impl("sym")
    with pytest.raises(ValueError, match="sym"):
        tphys.collision_forces(pos, obs.cfg)
    hd = gt.make_scenario("formation_hd_env", num_agents=4)
    hd.cfg.size[0] = 0.05  # mixed agent sizes: no reward kernel
    st = gt.state_from_numpy(_state_np(hd, 1, 0))
    set_reward_impl("auto")
    assert torch.isfinite(hd.reward(st)).all()
    set_reward_impl("sym")
    with pytest.raises(ValueError, match="sym"):
        hd.reward(st)


@pytest.mark.parametrize("impl", ["auto", "dense", "cull"])
def test_cpu_selectors_agree_f64(impl):
    """Every pair-force kernel's plain version gives the JAX package's
    forces on the hd_obs world (K8's only up to summation order)."""
    jcfg = ft.make_scenario("formation_hd_obs_env", num_agents=27).cfg
    tcfg = gt.make_scenario("formation_hd_obs_env", num_agents=27).cfg
    pos = np.random.RandomState(8).uniform(-0.6, 0.6, (2, jcfg.n_entities, 2))
    want = np.asarray(jax.vmap(lambda p: ft.core.physics.collision_forces(p, jcfg))(jnp.asarray(pos)))
    set_pallas_impl(impl)
    got = tphys.collision_forces(torch.as_tensor(pos), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("impl,hd_launch,obs_launch", [
    ("auto", "pairforce_sym_launch", "pairforce_launch"),
    ("dense", "pairforce_launch", "pairforce_launch"),
    ("cull", "pairforce_cull_launch", "pairforce_cull_launch"),
    ("sym", "pairforce_sym_launch", None),
])
def test_card_route_follows_pallas_impl(monkeypatch, impl, hd_launch, obs_launch):
    """On a (simulated) card each selector reaches its kernel's launcher:
    the uniform hd subset and the mixed hd_obs subset."""
    calls = fake_card(monkeypatch)
    set_pallas_impl(impl)
    hd = gt.make_scenario("formation_hd_env", num_agents=9).cfg
    tphys.collision_forces(torch.zeros(2, hd.n_entities, 2), hd)
    obs = gt.make_scenario("formation_hd_obs_env", num_agents=9).cfg
    if obs_launch is None:
        with pytest.raises(ValueError):
            tphys.collision_forces(torch.zeros(2, obs.n_entities, 2), obs)
    else:
        tphys.collision_forces(torch.zeros(2, obs.n_entities, 2), obs)
    assert calls == [hd_launch] + ([obs_launch] if obs_launch else [])


@pytest.mark.parametrize("impl,launch", [
    ("auto", "reward_sym_launch"), ("sym", "reward_sym_launch"), ("rowmajor", "reward_launch"),
])
def test_card_route_follows_reward_impl(monkeypatch, impl, launch):
    calls = fake_card(monkeypatch)
    set_reward_impl(impl)
    scen = gt.make_scenario("formation_hd_env", num_agents=9)
    scen._hd_stats(torch.zeros(2, 9, 2), torch.zeros(2, 9, 2))
    assert calls == [launch]
