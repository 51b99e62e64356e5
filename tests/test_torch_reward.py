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


# N = 1..300 in three groups, each a test: every tile side R = 2, 4, 8, 16,
# every ragged last super-tile, and two super-tiles of 256 (N > 256)
@pytest.mark.parametrize("lo,hi", [(1, 65), (65, 129), (129, 301)])
def test_k2_tile_schedule_covers_each_distance_and_pair_once(lo, hi):
    """The card kernel's schedule (tile_schedule_plain, its loops in numpy)
    computes each (agent, vertex) distance once and tests each unordered
    agent pair once: a pair skipped or taken twice would move a count."""
    for N in range(lo, hi):
        dist, pair = reward_sym.tile_schedule_plain(N)
        assert (dist == 1).all(), N
        assert np.array_equal(pair, np.triu(np.ones((N, N), np.int64), 1)), N


def test_k2_wrapper_limits_on_a_simulated_card(monkeypatch):
    """The tile side R by N, as the launcher picks it; on a (simulated) card
    every N up to MAX_AGENTS, 6400 (at least the 2042 the kernel held
    before), reaches the launcher, its padded layout within the H100's 227
    KB a block; beyond it the wrapper raises."""
    from test_torch_physics import fake_card

    sides = [reward_sym.tile_side(N) for N in (1, 32, 33, 64, 65, 128, 129, 243, 6400)]
    assert sides == [2, 2, 4, 4, 8, 8, 16, 16, 16]
    top = reward_sym.MAX_AGENTS
    assert top >= 2042 and reward_sym._smem_bytes(top) <= 232448 < reward_sym._smem_bytes(top + 1)
    calls = fake_card(monkeypatch)
    for N in (1, 243, top):
        reward_sym.hd_reward_stats_sym(torch.zeros(2, N, 2), torch.zeros(2, N, 2), thresh=THRESH)
    assert calls == ["reward_sym_launch"] * 3
    with pytest.raises(ValueError, match="at most"):
        reward_sym.hd_reward_stats_sym(torch.zeros(1, top + 1, 2), torch.zeros(1, top + 1, 2), thresh=THRESH)
