"""The yardstick's counts against hand counts at N=3 and N=9."""

import pytest

from perfbench import counts as C


@pytest.mark.parametrize("n,pairs,stats,step", [(3, 78, 87, 225), (9, 936, 855, 1971)])
def test_env_step_counts(n, pairs, stats, step):
    # pairs: n(n-1)/2 unordered × 18 + n(n-1) directions × 4
    # stats: n² × 7 + n(n-1)/2 × 6 + n(n-1) × 1; step adds 20 an agent
    assert C.pair_ops(n * (n - 1)) == pairs
    assert C.stat_ops(n) == stats
    assert C.env_step_ops(n) == step


@pytest.mark.parametrize("n,ops", [(3, 1 * 225 + 3 * 4), (9, 4 * 225 + 9 * 4)])
def test_bfs_policy_ops(n, ops):
    # (n - 1) / 2 pyramid rows of 12 + 57 + 3 × 52, and 4 an agent
    assert C.bfs_policy_ops(n) == ops


def test_mlp_flops():
    assert C.mlp_flops((18, 64, 64, 2)) == 2 * (18 * 64 + 64 * 64 + 64 * 2) == 10752


@pytest.mark.parametrize("n,dense", [(3, 48000), (9, 9 * 2 * 54 * 64 + 2 * 486 * 64 + 9 * 8576 + 8448)])
def test_forward_dense(n, dense):
    # actor: n rows of 6n·64 and the tail (64·64 + 64·2 multiply-adds and
    # two relus of 64); critic: one row of 6n·n·64 and its tail
    assert C.forward_ops(n, factorized=False) == dense


def test_forward_factorized_by_hand():
    # N=9, H=64: an agent 3 products of 2·64 multiply-adds, the prefix 64,
    # three adds 192 (1024); TOT 8 × 256; shape and velocity 18 × 128 + 256;
    # the differences 16.  Critic: 4 × 18 × 128 + 256 + 320.
    assert C.actor_first_factorized(9) == 9 * 1024 + 8 * 256 + 18 * 128 + 256 + 16
    assert C.critic_first_factorized(9) == 4 * 18 * 128 + 256 + 320
    assert C.forward_ops(9, True) == C.actor_first_factorized(9) + C.critic_first_factorized(9) + 9 * 8576 + 8448
    # the factorized layers stay far below the dense products at N=243
    assert C.forward_ops(243, True) < C.forward_ops(243, False) / 20


@pytest.mark.parametrize("n", [3, 9])
def test_iteration_and_step_ops(n):
    f = C.forward_ops(n, False)
    B, T, E = 10, 25, 10
    assert C.iteration_ops(n, B, T, E, False) == B * T * (C.env_step_ops(n) + f) + B * f + E * 3 * B * T * f
    assert C.rollout_step_ops(n, B) == B * (C.env_step_ops(n) + C.bfs_policy_ops(n))


def test_bounds():
    B = 1000
    assert C.k1_bound_s(3, B) == max(16 * B * 3 / C.HBM_BYTES_PER_S, B * 78 / C.FP32_OPS_PER_S)
    assert C.k2_bound_s(9, B) == max((16 * B * 9 + 4 * B + 4 * B * 9) / C.HBM_BYTES_PER_S,
                                     B * 855 / C.FP32_OPS_PER_S)
    assert C.k3_bound_s(9, B) == max((44 * B * 9 + 12 * B) / C.HBM_BYTES_PER_S,
                                     B * (1971 + 936) / C.FP32_OPS_PER_S)
    actor, critic = C.mlp_flops((18, 64, 64, 2)), C.mlp_flops((54, 64, 64, 1))
    assert C.k5_bound_s(3, B, 25) == max(B * (8 * 21 + 4 * 25 * 66) / C.HBM_BYTES_PER_S,
                                         B * 25 * (3 * actor + critic + 225) / C.FP32_OPS_PER_S)
    M = B * 25
    assert C.k9_bound_s(3, M) == max(4 * M * 66 / C.HBM_BYTES_PER_S,
                                     M * (3 * (2 * actor + 8448) + 2 * critic + 8320) / C.FP32_OPS_PER_S)
