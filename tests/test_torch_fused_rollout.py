"""The port's fused rollouts on the CPU (plain versions of K3, K2 and K4):

- ``rollout_statepolicy_fused`` against the port's step path across two
  auto-resets (the same generator draws), and against the JAX package's
  ``rollout_statepolicy_fused(interpret=True)`` within the first episode;
- the whole-rollout K4 against the JAX ``fused_rollout_hd(interpret=True)``
  across resets (its counter PRNG is reproduced bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.core.types import EnvState as JEnvState
from gym_formation_tpu.envs.formation_hd import FormationHDScenario as JHDScenario
from gym_formation_tpu.ops.pallas import fused_rollout as jfr

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.envs.formation_hd import FormationHDScenario
from gym_formation_tpu_torch.ops.kernels import fused_rollout as tfr
from gym_formation_tpu_torch.ops.kernels import fused_step, reward_sym

N, B, T, EP_LEN = 27, 3, 15, 6  # T crosses two auto-reset boundaries
CASES = [("external", "pre"), ("external", "post"), ("bfs_ez", "pre"), ("bfs_ez", "post")]


def _ez_state(n):
    """A cheap external state policy (the JAX tests' _ez_state): pull toward
    the index-matched ideal vertex, plus the ideal velocity."""

    def policy(st, generator=None):
        apos = st.pos[:, :n]
        target = st.ideal_shape + apos.mean(1, keepdim=True)
        return torch.clamp(0.5 * (target - apos), -1.0, 1.0) + st.ideal_vel[:, None]

    return policy


def _env(n=N, ep_len=EP_LEN):
    return gt.FormationEnv(FormationHDScenario(num_agents=n, episode_length=ep_len))


def _state_np(n, B, seed):
    rng = np.random.RandomState(seed)
    apos = rng.uniform(-1, 1, (B, n, 2))
    ishape = rng.uniform(-1, 1, (B, n, 2))
    ishape -= ishape.mean(1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        pos=f32(np.concatenate([apos, ishape + apos.mean(1, keepdims=True)], 1)),
        vel=f32(np.concatenate([rng.uniform(-0.3, 0.3, (B, n, 2)), np.zeros((B, n, 2))], 1)),
        c=np.zeros((B, n, 2), np.float32),
        ideal_shape=f32(ishape),
        ideal_vel=f32(rng.uniform(-1, 1, (B, 2))),
        t=np.zeros(B, np.int32),
    )


@pytest.mark.parametrize("policy,stats", CASES)
def test_fused_rollout_matches_step_path(policy, stats):
    """Same generator seed: the fused rollout draws the same reset episodes
    as rollout_statepolicy, so the two agree across both resets.
    Tolerances of tests/test_fused_rollout_hd.py."""
    env = _env()
    g = torch.Generator()
    g.manual_seed(0)
    state = env.reset_state(g, B)
    if policy == "bfs_ez":
        step_policy = lambda s, gen: gt.bfs_actions_from_state(gt.ezpolicy_batched, env.scenario, s, 3)
        fused_policy = None
    else:
        step_policy = fused_policy = _ez_state(N)
    g.manual_seed(1)
    st_ref, rew_ref = gt.rollout_statepolicy(env, step_policy, state, g, T)
    g.manual_seed(1)
    st_f, rew = gt.rollout_statepolicy_fused(env, fused_policy, state, g, T, stats=stats, policy=policy)
    assert rew.shape == (T, B)
    np.testing.assert_allclose(rew.numpy(), rew_ref.sum(-1).numpy(), atol=5e-3, rtol=1e-4)
    np.testing.assert_allclose(st_f.pos.numpy(), st_ref.pos.numpy(), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(st_f.vel.numpy(), st_ref.vel.numpy(), atol=1e-3, rtol=1e-4)
    np.testing.assert_array_equal(st_f.t.numpy(), st_ref.t.numpy())
    assert int(st_f.t.max()) < T  # the episodes did reset


@pytest.mark.parametrize("policy,stats", CASES)
def test_fused_rollout_matches_jax_within_episode(policy, stats):
    """The same injected state through the JAX fused rollout (interpret
    mode) and the port's, for T=5 steps of the first episode (the two
    packages draw their resets from different generators)."""
    n, b, steps = N, B, 5
    st = _state_np(n, b, 3)
    jenv = ft.FormationEnv(JHDScenario(num_agents=n, episode_length=EP_LEN))
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    jst = JEnvState(**{k: jnp.asarray(v) for k, v in st.items()}, key=keys)
    jpol = None
    if policy == "external":
        def jpol(s, k):
            apos = s.pos[:n]
            target = s.ideal_shape + apos.mean(axis=0, keepdims=True)
            return jnp.clip(0.5 * (target - apos), -1.0, 1.0) + s.ideal_vel
    jfinal, jrew = ft.rollout_statepolicy_fused(
        jenv, jpol, jst, jax.random.split(jax.random.PRNGKey(1), b), steps,
        stats=stats, policy=policy, interpret=True,
    )
    env = _env()
    tpol = _ez_state(n) if policy == "external" else None
    tfinal, trew = gt.rollout_statepolicy_fused(
        env, tpol, gt.state_from_numpy(st), torch.Generator(), steps, stats=stats, policy=policy)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=5e-3, rtol=1e-4)
    np.testing.assert_allclose(tfinal.pos.numpy(), np.asarray(jfinal.pos), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), atol=1e-3, rtol=1e-4)
    np.testing.assert_array_equal(tfinal.t.numpy(), np.asarray(jfinal.t))


def test_fused_rollout_rejects_unsupported():
    env = _env(9)
    g = torch.Generator()
    state = env.reset_state(g, 2)
    with pytest.raises(ValueError, match="stats"):
        gt.rollout_statepolicy_fused(env, _ez_state(9), state, g, 2, stats="mid")
    with pytest.raises(ValueError, match="policy"):
        gt.rollout_statepolicy_fused(env, _ez_state(9), state, g, 2, policy="mlp")
    env4 = _env(4)
    with pytest.raises(ValueError):  # 4 agents are no arity-3 hierarchy
        gt.rollout_statepolicy_fused(env4, None, env4.reset_state(g, 2), g, 2, policy="bfs_ez")
    assert (fused_step.launches, reward_sym.launches) == (0, 0)


# -- K4 -----------------------------------------------------------------------

def _soa_np(n, B, ep_len, seed):
    """SoA planes with episode counters spread over [0, ep_len)."""
    rng = np.random.RandomState(seed)
    ap = rng.uniform(-1, 1, (2 * n, B))
    av = rng.uniform(-0.2, 0.2, (2 * n, B))
    ish = rng.uniform(-1, 1, (2 * n, B))
    ish[:n] -= ish[:n].mean(0)
    ish[n:] -= ish[n:].mean(0)
    iv = rng.uniform(-1, 1, (2, B))
    t = rng.randint(0, ep_len, (1, B)).astype(np.int32)
    return [a.astype(np.float32) for a in (ap, av, ish, iv)] + [t]


@pytest.mark.parametrize("n,T,ep_len", [(3, 30, 12), (4, 30, 12), (9, 16, 8)])
def test_k4_plain_matches_jax_across_resets(n, T, ep_len):
    """Every env resets at least twice within T; the reset draws are the
    same bits, so states are compared after the resets too.  Tolerances of
    tests/test_fused_rollout.py (state 1e-5 for n < 9, 3e-4 at n=9 where
    contacts fire; reward sum rtol 5e-6, atol 2e-3)."""
    planes = _soa_np(n, 32, ep_len, n)
    js, jr = jfr.fused_rollout_hd(jfr.SoAState(*(jnp.asarray(a) for a in planes)), 7,
                                  length=T, ep_len=ep_len, n=n, block=32, interpret=True)
    ts, tr = tfr.fused_rollout_hd(tfr.SoAState(*(torch.as_tensor(a) for a in planes)), 7,
                                  length=T, ep_len=ep_len, n=n)
    tol = 1e-5 if n < 9 else 3e-4
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=5e-6, atol=2e-3)
    for name in ("ap", "av", "ishape", "ivel"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=tol, err_msg=name)
    np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
    assert tfr.launches == 0


@pytest.mark.parametrize("seed,it", [(7, 0), (-3, 5), (2**31 - 1, 123)])
def test_k4_prng_bits_match_jax(seed, it):
    lane = np.arange(64)
    want = np.asarray(jfr._uniform_pm1(jnp.int32(seed), jnp.int32(it),
                                       jnp.asarray(lane, jnp.uint32)[None, :], 14))
    got = tfr.uniform_pm1(seed, it, torch.as_tensor(lane), 14).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    x = np.random.RandomState(it).randint(0, 2**32, 1000, dtype=np.uint64)
    np.testing.assert_array_equal(
        tfr.hash_u32(torch.as_tensor(x.astype(np.int64))).numpy(),
        np.asarray(jfr._hash_u32(jnp.asarray(x, jnp.uint32))).astype(np.int64))


def test_soa_roundtrip_matches_jax():
    n, b = 9, 4
    st = _state_np(n, b, 2)
    st["t"] = np.arange(b, dtype=np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    jst = JEnvState(**{k: jnp.asarray(v) for k, v in st.items()}, key=keys)
    jsoa = jfr.state_to_soa(jst)
    tst = gt.state_from_numpy(st)
    tsoa = tfr.state_to_soa(tst)
    for name in tfr.SoAState._fields:
        np.testing.assert_array_equal(getattr(tsoa, name).numpy(), np.asarray(getattr(jsoa, name)))
    back = tfr.soa_to_state(tsoa, tst)
    jback = jfr.soa_to_state(jsoa, jst)
    for k in ("pos", "vel", "ideal_shape", "ideal_vel", "t"):
        np.testing.assert_allclose(getattr(back, k).numpy(), np.asarray(getattr(jback, k)), atol=1e-6)
    # landmarks are recentred in the state, so the round trip is exact up to rounding
    np.testing.assert_allclose(back.pos.numpy(), st["pos"], atol=1e-6)
    np.testing.assert_array_equal(back.t.numpy(), st["t"])


def test_k4_launch_plan():
    """G, the envs of a warp, is 32 // n (one lane an agent); two warps a
    block; the grid is one env group a warp, cut at one wave."""
    assert {n: tfr.launch_plan(n) for n in tfr.KERNEL_AGENTS} == {3: (10, 64), 4: (8, 64), 9: (3, 64)}
    with pytest.raises(ValueError, match="built for n"):
        tfr.launch_plan(5)
    assert tfr.grid_blocks(4096, 20, 8, 132) == 205  # 410 warps
    assert tfr.grid_blocks(4096, 6, 8, 132) == 683
    assert tfr.grid_blocks(4096, 6, 2, 132) == 264  # one wave; the warps walk the rest
    assert tfr.grid_blocks(1, 20, 8, 132) == 1 and tfr.grid_blocks(0, 20, 8, 132) == 1


@pytest.mark.parametrize("n", [3, 4, 9])
@pytest.mark.parametrize("B", [1, 7, 37, 4096])
def test_k4_schedule_covers_each_env_once(n, B):
    """Every env runs on exactly one group, every (env, agent) on exactly one
    lane, a group's lanes lie in one warp in one round, and no lane holds
    two: with one group a warp, with the grid of one wave on 132 SMs at two
    blocks an SM, and with a few blocks walking many groups."""
    G, threads = tfr.launch_plan(n)
    for grid in (None, tfr.grid_blocks(B, G * threads // 32, 2, 132), 3):
        sched = tfr.rollout_schedule_plain(n, B, grid)
        assert (sched["env"] == 1).all() and (sched["agent"] == 1).all(), grid
        env, agent = sched["lane_env"], sched["lane_agent"]
        live = env >= 0
        assert ((agent >= 0) == live).all() and (agent < n).all()
        assert live.sum() == B * n
        for r in range(env.shape[0]):
            tid = np.flatnonzero(live[r])
            assert len(set(zip(env[r, tid], agent[r, tid]))) == tid.size  # one (env, agent) a lane
            warp = tid // 32
            for b in np.unique(env[r, tid]):
                on = tid[env[r, tid] == b]
                assert on.size == n and np.unique(warp[env[r, tid] == b]).size == 1
                assert (agent[r, on] == on % 32 % n).all()
