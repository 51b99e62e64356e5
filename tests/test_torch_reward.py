"""The port's formation_hd reward statistics: kernel K2's plain version and
the scenario reward, held against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.ops.pallas.reward_sym import hd_reward_stats_sym as j_k2

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.ops.kernels import reward_sym

THRESH = 0.03  # (s1+s2)/2 with agent size 0.03


def _inputs(n, B, seed, scale, dtype=np.float32):
    rng = np.random.RandomState(seed)
    apos = (rng.uniform(-1, 1, (B, n, 2)) * scale).astype(dtype)
    ishape = rng.uniform(-1, 1, (B, n, 2))
    return apos, (ishape - ishape.mean(1, keepdims=True)).astype(dtype)


# scale < 1 squeezes the agents into collision range
@pytest.mark.parametrize("scale", [1.0, 0.05])
def test_k2_plain_matches_xla_and_pallas(scale):
    n, B = 27, 3
    apos, ishape = _inputs(n, B, 11, scale)
    scen = ft.make_env("formation_hd_env", num_agents=n).scenario
    h_x, nc_x = jax.vmap(scen._hd_stats_xla)(jnp.asarray(apos), jnp.asarray(ishape))
    h_p, nc_p = j_k2(jnp.asarray(apos), jnp.asarray(ishape), thresh=THRESH, interpret=True)
    h_t, nc_t = reward_sym.hd_reward_stats_sym(
        torch.as_tensor(apos), torch.as_tensor(ishape), thresh=THRESH)
    for h, nc in ((h_x, nc_x), (h_p, nc_p)):
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h), atol=1e-6)
        np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc))
    if scale < 1.0:
        assert nc_t.sum() > 0  # collisions present


def test_hd_stats_plain_matches_xla_f64():
    n, B = 27, 3
    apos, ishape = _inputs(n, B, 12, 0.05, np.float64)
    jscen = ft.make_env("formation_hd_env", num_agents=n).scenario
    tscen = gt.make_env("formation_hd_env", num_agents=n).scenario
    h_x, nc_x = jax.vmap(jscen._hd_stats_xla)(jnp.asarray(apos), jnp.asarray(ishape))
    h_t, nc_t = tscen._hd_stats_plain(torch.as_tensor(apos), torch.as_tensor(ishape))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_x), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc_x))
    assert nc_t.sum() > 0


@pytest.mark.parametrize("n", [27, 243])
def test_scenario_reward_matches_jax(n):
    """The whole per-agent reward (Hausdorff, velocity and collision terms)
    on one squeezed state, through the port's K2 dispatch."""
    B = 2
    rng = np.random.RandomState(n)
    apos, ishape = _inputs(n, B, n, 0.05)
    st = dict(
        pos=np.concatenate([apos, ishape], 1),
        vel=rng.uniform(-0.5, 0.5, (B, 2 * n, 2)).astype(np.float32),
        c=np.zeros((B, n, 2), np.float32),
        ideal_shape=ishape,
        ideal_vel=rng.uniform(-1, 1, (B, 2)).astype(np.float32),
        t=np.zeros(B, np.int32),
    )
    jscen = ft.make_env("formation_hd_env", num_agents=n).scenario
    jstate = jscen.zero_state(jax.random.PRNGKey(0))
    jstate = jax.vmap(lambda p, v, s, iv: jstate.replace(pos=p, vel=v, ideal_shape=s, ideal_vel=iv))(
        *(jnp.asarray(st[k]) for k in ("pos", "vel", "ideal_shape", "ideal_vel")))
    want = np.asarray(jax.vmap(jscen.reward)(jstate))
    tscen = gt.make_env("formation_hd_env", num_agents=n).scenario
    got = tscen.reward(gt.state_from_numpy(st)).numpy()
    assert want.min() < -1.0  # collision terms present
    np.testing.assert_allclose(got, want, atol=1e-5)
