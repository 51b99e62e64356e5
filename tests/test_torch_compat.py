"""The port's exact-match harness (``compat``) against the JAX package's:
``host_reset`` replays the same MT19937 draws in the same order for all five
scenarios (exactly, in float64), and ``state_from_numpy`` loads host arrays
into the same state field by field, as a batch of one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu import compat as jcompat

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import compat as tcompat
from gym_formation_tpu_torch.core import state_from_numpy as batched_state_from_numpy

SCENARIOS = [("formation_hd_env", 4), ("basic_formation_env", 3), ("formation_hd_partial_env", 5),
             ("formation_hd_partial_range_env", 5), ("formation_hd_obs_env", 4)]
FIELDS = ("pos", "vel", "c", "ideal_shape", "ideal_vel", "t")


def scenarios(name, n):
    """The scenario in both packages, in float64."""
    return (ft.make_scenario(name, num_agents=n, dtype=jnp.float64),
            gt.make_scenario(name, num_agents=n, dtype=torch.float64))


def assert_same_state(tst, jst):
    for f in FIELDS:
        got, want = getattr(tst, f), np.asarray(getattr(jst, f))
        assert got.shape == (1,) + want.shape, f
        assert got.dtype == (torch.int32 if f == "t" else torch.float64), f
        np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f)


@pytest.mark.parametrize("seed", [None, 7])
@pytest.mark.parametrize("name,n", SCENARIOS)
def test_host_reset_matches_jax(name, n, seed):
    jscen, tscen = scenarios(name, n)
    tst = tcompat.host_reset(tscen, seed, device="cpu")
    assert_same_state(tst, jcompat.host_reset(jscen, seed))
    # a shared RandomState: the second reset continues the same stream
    jr, tr = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):
        assert_same_state(tcompat.host_reset(tscen, rng=tr, device="cpu"), jcompat.host_reset(jscen, rng=jr))
    assert tst.pos.device.type == "cpu"


def test_host_reset_defaults_to_the_original_seed():
    jscen, tscen = scenarios("formation_hd_env", 3)
    np.testing.assert_array_equal(tcompat.host_reset(tscen, device="cpu").pos.numpy(),
                                  tcompat.host_reset(tscen, seed=1, device="cpu").pos.numpy())
    assert not np.array_equal(tcompat.host_reset(tscen, seed=2, device="cpu").pos.numpy(),
                              tcompat.host_reset(tscen, seed=1, device="cpu").pos.numpy())


def test_state_from_numpy_matches_jax_field_by_field():
    jscen, tscen = scenarios("formation_hd_env", 3)
    rng = np.random.RandomState(0)
    arrays = dict(agent_pos=rng.uniform(-1, 1, (3, 2)), landmark_pos=rng.uniform(-1, 1, (3, 2)),
                  agent_vel=rng.uniform(-1, 1, (3, 2)), landmark_vel=rng.uniform(-1, 1, (3, 2)),
                  ideal_shape=rng.uniform(-1, 1, (3, 2)), ideal_vel=rng.uniform(-1, 1, 2), t=4)
    assert_same_state(tcompat.state_from_numpy(tscen, **arrays, device="cpu"), jcompat.state_from_numpy(jscen, **arrays))
    # the optional fields default to zeros, as in JAX
    short = dict(agent_pos=arrays["agent_pos"], landmark_pos=arrays["landmark_pos"])
    assert_same_state(tcompat.state_from_numpy(tscen, **short, device="cpu"), jcompat.state_from_numpy(jscen, **short))
    # dtype: the scenario's unless given
    f32 = tcompat.state_from_numpy(gt.make_scenario("formation_hd_env", num_agents=3), **short, device="cpu")
    assert f32.pos.dtype == torch.float32
    assert tcompat.state_from_numpy(tscen, dtype=torch.float32, **short, device="cpu").vel.dtype == torch.float32


def test_compat_entry_points_default_to_the_card(monkeypatch):
    """``host_reset`` and ``state_from_numpy`` build on the card unless
    ``device="cpu"`` is given, and without a card they raise instead of
    moving to the CPU."""
    _, tscen = scenarios("formation_hd_env", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompat.host_reset(tscen, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompat.state_from_numpy(tscen, np.zeros((3, 2)), np.zeros((3, 2)))


def test_compat_state_steps_like_the_batched_loader():
    """The one-env loader and the batched ``core.state_from_numpy`` give the
    same state for the same arrays, so both packages' tests can inject
    either."""
    _, tscen = scenarios("formation_hd_env", 3)
    one = tcompat.host_reset(tscen, 5, device="cpu")
    again = batched_state_from_numpy({f: getattr(one, f).numpy() for f in FIELDS}, dtype=torch.float64)
    for f in FIELDS:
        assert torch.equal(getattr(again, f), getattr(one, f)), f
