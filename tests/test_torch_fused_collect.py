"""K5 on the CPU: the port's ``fused_collect_hd_plain`` against the JAX
package's ``fused_collect_hd(interpret=True)`` on the same SoA state,
network weights and seed (the counter PRNG is reproduced bit for bit, so
trajectories are compared across auto-resets too), and the stored logp and
value against the port's networks re-applied."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MAPPO as JMAPPO, MAPPOConfig as JMAPPOConfig
from gym_formation_tpu.ops.pallas import fused_collect as jfc
from gym_formation_tpu.ops.pallas import fused_rollout as jfr

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.models.networks import actor_from_flax, critic_from_flax, gaussian_logp
from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
from gym_formation_tpu_torch.ops.kernels import fused_rollout as tfr

N, B, T = 3, 16, 10


def _jax_setup(n=N):
    env = ft.FormationEnv(ft.make_env("formation_hd_env", num_agents=n).scenario)
    algo = JMAPPO(env, JMAPPOConfig(rollout_len=T), num_envs=B)
    ts, es, _ = algo.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, ts.params)
    # a log-std away from 0 and a larger head, so that the policy's mean
    # matters next to the noise
    params["actor"]["params"]["log_std"] = np.full(2, -0.7, np.float32)
    params["actor"]["params"]["Dense_0"]["kernel"] = params["actor"]["params"]["Dense_0"]["kernel"] * 50.0
    return es, params


@pytest.mark.parametrize("ep_len", [100, 4])
def test_k5_plain_matches_jax(ep_len):
    """Trajectory and final state against the JAX kernel (interpret mode);
    ep_len=4 crosses two resets.  Tolerances of tests/test_fused_collect.py
    (network outputs rtol = atol = 1e-4; obs 3e-4, reward 2e-4 as its
    dynamics test); done and the episode counters exact."""
    es, params = _jax_setup()
    jsoa, jtraj = jfc.fused_collect_hd(
        jfr.state_to_soa(es), jfc.actor_planes(params["actor"]), jfc.critic_planes(params["critic"]),
        5, length=T, ep_len=ep_len, n=N, block=B, interpret=True,
    )
    soa = tfr.state_to_soa(gt.state_from_numpy(es))
    actor, critic = actor_from_flax(params["actor"]), critic_from_flax(params["critic"])
    tsoa, ttraj = k5.fused_collect_hd(soa, k5.actor_planes(actor), k5.critic_planes(critic), 5,
                                      length=T, ep_len=ep_len, n=N)
    assert k5.launches == 0
    shapes = dict(obs=(T, B, N, 6 * N), action=(T, B, N, 2), logp=(T, B, N), value=(T, B),
                  reward=(T, B), done=(T, B))
    for k, s in shapes.items():
        assert tuple(ttraj[k].shape) == s, k
    assert ttraj["done"].dtype == torch.bool
    np.testing.assert_array_equal(ttraj["done"].numpy(), np.asarray(jtraj["done"]))
    np.testing.assert_array_equal(tsoa.t.numpy(), np.asarray(jsoa.t))
    if ep_len < T:
        assert ttraj["done"].any(0).all()
    np.testing.assert_allclose(ttraj["obs"].numpy(), np.asarray(jtraj["obs"]), atol=3e-4)
    np.testing.assert_allclose(ttraj["action"].numpy(), np.asarray(jtraj["action"]), rtol=1e-4, atol=1e-4)
    for k in ("logp", "value"):
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(ttraj["reward"].numpy(), np.asarray(jtraj["reward"]), rtol=2e-4, atol=2e-4)
    for name in ("ap", "av", "ishape", "ivel"):
        np.testing.assert_allclose(getattr(tsoa, name).numpy(), np.asarray(getattr(jsoa, name)),
                                   atol=3e-4, err_msg=name)


def test_k5_stored_logp_value_match_networks():
    """Stored value and logp equal the port's networks applied to the
    stored obs and actions (tests/test_fused_collect.py's network parity)."""
    es, params = _jax_setup()
    actor, critic = actor_from_flax(params["actor"]), critic_from_flax(params["critic"])
    soa = tfr.state_to_soa(gt.state_from_numpy(es))
    _, tr = k5.fused_collect_hd(soa, k5.actor_planes(actor), k5.critic_planes(critic), 3,
                                length=T, ep_len=6, n=N)
    obs = tr["obs"].reshape(T * B, N, 6 * N)
    with torch.no_grad():
        v = critic(obs.reshape(T * B, -1))
        lp = gaussian_logp(*actor(obs), tr["action"].reshape(T * B, N, 2))
    np.testing.assert_allclose(tr["value"].reshape(-1).numpy(), v.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr["logp"].reshape(T * B, N).numpy(), lp.numpy(), rtol=1e-4, atol=1e-4)
    # the operands: [out, in] weights, the soft-bounded log-std
    ops = k5.actor_planes(actor)
    jops = jfc.actor_planes(params["actor"])
    for t, j in zip(ops, jops):
        np.testing.assert_allclose(t.numpy(), np.asarray(j).reshape(t.shape), rtol=1e-6, atol=1e-7)
    for t, j in zip(k5.critic_planes(critic), jfc.critic_planes(params["critic"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j).reshape(t.shape), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed,it,salt", [(5, 0, 1), (-3, 7, 8), (2**31 - 1, 24, 3)])
def test_k5_prng_matches_jax(seed, it, salt):
    """The uniforms bit for bit; the Box-Muller normals to float32 rounding
    of log and cos."""
    lane = np.arange(40)
    jl = jnp.asarray(lane, jnp.uint32)[None, :]
    want = np.asarray(jfc._uniform01(jnp.int32(seed), jnp.int32(it), jl, 14, salt))
    got = k5.uniform01(seed, it, torch.as_tensor(lane), 14, salt).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    want_n = np.asarray(jfc._normal(jnp.int32(seed), jnp.int32(it), jl, 6, salt))
    got_n = k5.normal(seed, it, torch.as_tensor(lane), 6, salt).numpy()
    np.testing.assert_allclose(got_n, want_n, rtol=1e-5, atol=1e-5)


def test_k5_plain_other_agent_counts():
    """n=4 and n=9 (the other instantiations of the kernel) against JAX
    within the first episode."""
    for n in (4, 9):
        es, params = _jax_setup(n)
        jsoa, jtraj = jfc.fused_collect_hd(
            jfr.state_to_soa(es), jfc.actor_planes(params["actor"]), jfc.critic_planes(params["critic"]),
            2, length=3, ep_len=100, n=n, block=B, interpret=True,
        )
        actor, critic = actor_from_flax(params["actor"]), critic_from_flax(params["critic"])
        tsoa, tr = k5.fused_collect_hd(tfr.state_to_soa(gt.state_from_numpy(es)), k5.actor_planes(actor),
                                       k5.critic_planes(critic), 2, length=3, ep_len=100, n=n)
        for k in ("action", "logp", "value", "reward"):
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jtraj[k]), rtol=1e-4, atol=2e-4, err_msg=(n, k))
        np.testing.assert_allclose(tsoa.ap.numpy(), np.asarray(jsoa.ap), atol=1e-4)


def test_k5_launch_plan():
    """E, the envs of a tile, by n: the largest of 16, 8, 4, 2, 1 whose
    block fits the H100's 227 KB of shared memory; the bytes are the
    kernel's layout (csrc/fused_collect.cu: Dims)."""
    assert {n: k5.launch_plan(n) for n in k5.KERNEL_AGENTS} == {3: (16, 95632), 4: (16, 120464), 9: (4, 213904)}
    for n in k5.KERNEL_AGENTS:
        E, smem = k5.launch_plan(n)
        assert smem == k5.smem_bytes(n, E) <= k5._SMEM_MAX
        assert E == 16 or k5.smem_bytes(n, 2 * E) > k5._SMEM_MAX
    # the weights alone: 53.0, 65.3 and 172.8 KB at n = 3, 4, 9
    for n, kb in ((3, 53.0), (4, 65.3), (9, 172.8)):
        do, dc = 6 * n, 6 * n * n
        assert round(4 * (do * 64 + 64 + 64 * 64 + 64 + 2 * 64 + 2 + dc * 64 + 64 + 64 * 64 + 64 + 64 + 1) / 1000, 1) == kb
    assert k5.grid_blocks(4096, 16, 2, 132) == 256 and k5.grid_blocks(7, 16, 2, 132) == 1
    assert k5.grid_blocks(4096, 4, 1, 132) == 132


@pytest.mark.parametrize("n", [3, 4, 9])
@pytest.mark.parametrize("B", [1, 7, 37, 4096])
def test_k5_schedule_covers_each_output_once(n, B):
    """The persistent loop visits every env once, and every (row, unit)
    output of each layer and every head output reaching the trajectory is
    computed once, with one tile a block, with the grid of one wave on 132
    SMs, and with a few blocks walking many tiles."""
    E, _ = k5.launch_plan(n)
    for G in (None, k5.grid_blocks(B, E, 1, 132), 3):
        sched = k5.collect_schedule_plain(n, E, B, G)
        assert set(sched) == {"env", "actor1", "actor2", "critic1", "critic2", "mean", "value"}
        for name, count in sched.items():
            assert (count == 1).all(), (name, G)
        assert sched["actor1"].shape == (B * n, 64) and sched["mean"].shape == (B, n, 2)
