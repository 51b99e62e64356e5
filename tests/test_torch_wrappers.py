"""The port's imperative adapters: the JAX package's contract tests of
``tests/test_wrappers.py`` ported (list lengths, the ``[[r]]`` nesting,
per-agent info dicts, the time-limit done, seed determinism, the dict
adapter's ``__all__`` and v3 info), the auto-reset rebuild, ``step`` before
``reset``, the card as the default device, and 10 steps from the same
injected ``host_reset`` state under the same actions against JAX's
``GymMultiAgentEnv`` and ``DictAgentEnv`` in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu import compat as jcompat

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import compat as tcompat

QUARTET = {"individual_reward", "reward", "collisions", "min_dists", "occupied_landmarks"}


@pytest.fixture(scope="module")
def gym_env():
    return gt.GymMultiAgentEnv("formation_hd_env", benchmark=True, num_agents=3, episode_length=5, device="cpu")


def test_gym_env_reference_contract(gym_env):
    env = gym_env
    env.seed(3)
    obs_n = env.reset()
    assert isinstance(obs_n, list) and len(obs_n) == 3
    assert obs_n[0].shape == (env.observation_space[0].shape[0],)

    acts = [np.zeros(2, np.float32) for _ in range(3)]
    obs_n, reward_n, done_n, info_n = env.step(acts)
    assert len(obs_n) == 3 and isinstance(obs_n[0], np.ndarray)
    assert reward_n == [[reward_n[0][0]]] * 3  # the shared-reward broadcast
    assert isinstance(reward_n[0], list) and isinstance(reward_n[0][0], float)
    assert done_n == [False] * 3 and isinstance(done_n[0], bool)
    assert len(info_n) == 3
    for info in info_n:
        assert QUARTET <= set(info.keys())
    for _ in range(4):  # the time-limit done at episode_length 5
        _, _, done_n, _ = env.step(acts)
    assert done_n == [True] * 3
    assert env.n == env.num_agents == 3 and env.world_length == 5


def test_gym_env_seed_determinism(gym_env):
    env = gym_env
    env.seed(11)
    a = env.reset()
    env.seed(11)
    b = env.reset()
    np.testing.assert_array_equal(np.stack(a), np.stack(b))
    env.seed(12)
    c = env.reset()
    assert not np.array_equal(np.stack(a), np.stack(c))
    env.seed()  # seed 1, the original environment's default
    d = env.reset()
    env.seed(1)
    np.testing.assert_array_equal(np.stack(d), np.stack(env.reset()))


def test_gym_env_render(gym_env):
    env = gym_env
    env.seed(0)
    env.reset()
    frame = env.render(size=64)
    assert frame.shape == (64, 64, 3) and frame.dtype == np.uint8


def test_step_and_render_before_reset_raise():
    env = gt.GymMultiAgentEnv("formation_hd_env", num_agents=3, device="cpu")
    with pytest.raises(RuntimeError, match="reset"):
        env.step([np.zeros(2)] * 3)
    with pytest.raises(RuntimeError, match="reset"):
        env.render()


def test_auto_reset_env_is_rebuilt_without_it():
    auto = gt.make_env("formation_hd_env", num_agents=3, episode_length=2, benchmark=True)
    assert auto.auto_reset
    env = gt.GymMultiAgentEnv(env=auto, device="cpu")
    assert not env._env.auto_reset and env._env.benchmark and env._env.scenario is auto.scenario
    env.reset()
    for _ in range(2):
        obs_n, _, done_n, _ = env.step([np.zeros(2)] * 3)
    # the terminal observation comes back, not a fresh episode's
    assert done_n == [True] * 3
    np.testing.assert_array_equal(np.stack(obs_n), env._env.scenario.observe(env.state)[0].numpy())
    assert int(env.state.t[0]) == 2


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.GymMultiAgentEnv("formation_hd_env", num_agents=3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.DictAgentEnv(scenario_name="formation_hd_env", num_agents=3)
    assert gt.GymMultiAgentEnv("formation_hd_env", num_agents=3, device="cpu").device.type == "cpu"


def test_dict_agent_env_contract():
    env = gt.DictAgentEnv(scenario_name="formation_hd_env", num_agents=3, episode_length=3, device="cpu")
    env.seed(5)
    obs = env.reset()
    assert set(obs.keys()) == {0, 1, 2}
    assert set(env.observation_space_dict) == {0, 1, 2} and set(env.action_space_dict) == {0, 1, 2}

    acts = {i: np.zeros(2, np.float32) for i in range(3)}
    obs, rew, done, info = env.step(acts)
    assert set(obs) == {0, 1, 2} and set(rew) == {0, 1, 2}
    assert isinstance(rew[0], list) and len(rew[0]) == 1  # the [r] nesting passes through
    assert set(done) == {0, 1, 2, "__all__"} and done["__all__"] is False
    assert info[0] == {"done": False}

    env.step(acts)
    _, _, done, info = env.step(acts)
    assert done["__all__"] is True and info[2] == {"done": True}
    assert env.render().shape == (350, 350, 3)


def _pair_f64(benchmark=True, n=3, **kw):
    jw = ft.GymMultiAgentEnv("formation_hd_env", benchmark=benchmark, num_agents=n, dtype=jnp.float64, **kw)
    tw = gt.GymMultiAgentEnv("formation_hd_env", benchmark=benchmark, num_agents=n, dtype=torch.float64,
                             device="cpu", **kw)
    return jw, tw


def _inject(jw, tw, seed):
    jw._state = jcompat.host_reset(jw._env.scenario, seed)
    tw.state = tcompat.host_reset(tw._env.scenario, seed, device="cpu")
    assert tw.state.pos.dtype == torch.float64


TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("seed", [1, 4])
def test_ten_steps_match_jax(seed):
    """The same injected state and the same actions through both
    wrappers: observations, rewards and the info quartet within 1e-9 in
    float64, done flags and the nesting exactly, across the time-limit done
    at step 8."""
    jw, tw = _pair_f64(episode_length=8)
    _inject(jw, tw, seed)
    rng = np.random.RandomState(seed)
    for t in range(10):
        acts = [rng.uniform(-1, 1, 2) for _ in range(3)]
        jo, jr, jd, ji = jw.step(acts)
        to, tr, td, ti = tw.step(acts)
        np.testing.assert_allclose(np.stack(to), np.stack(jo), **TOL, err_msg=f"obs at step {t}")
        np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), **TOL, err_msg=f"reward at step {t}")
        assert td == jd == [t + 1 >= 8] * 3
        for a in range(3):
            assert set(ti[a]) == set(ji[a]) == QUARTET
            for k in QUARTET:
                np.testing.assert_allclose(ti[a][k], np.asarray(ji[a][k]), **TOL, err_msg=f"{k} at step {t}")
    np.testing.assert_allclose(tw.state.pos[0].numpy(), np.asarray(jw.state.pos), **TOL)


def test_ten_dict_steps_match_jax():
    jw, tw = _pair_f64(benchmark=False, n=4)
    jd = ft.DictAgentEnv(scenario_name="formation_hd_env", num_agents=4, dtype=jnp.float64, episode_length=6)
    td = gt.DictAgentEnv(scenario_name="formation_hd_env", num_agents=4, dtype=torch.float64, episode_length=6,
                         device="cpu")
    _inject(jd._env, td._env, 2)
    rng = np.random.RandomState(0)
    for t in range(10):
        acts = {i: rng.uniform(-1, 1, 2) for i in range(4)}
        jo, jr, jdone, jinfo = jd.step(acts)
        to, tr, tdone, tinfo = td.step(acts)
        assert set(to) == set(jo) == {0, 1, 2, 3} and tdone == jdone and tinfo == jinfo
        for i in range(4):
            np.testing.assert_allclose(to[i], jo[i], **TOL)
            np.testing.assert_allclose(tr[i], jr[i], **TOL)
    assert tdone["__all__"] is True  # 10 steps passed the time limit of 6
