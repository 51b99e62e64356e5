"""The yardstick's operation and byte counts, and the H100's peaks.

Frozen copies of the counts that ``chip_smoke.py`` keeps for its kernel
table (``pair_ops``, ``stat_ops``, ``bfs_policy_ops``, ``env_step_ops``,
``mlp_flops``, ``bound`` and the per-kernel bounds), so that the benchmark's
roofline shares do not move when the program's files change.  Every count is
of FP32 operations as the function needs them (a multiply-add is two), and
every byte count reads each input once and writes each output once.

``iteration_ops`` and ``rollout_step_ops`` are the one count a configuration
has for its MFU: the work of an iteration (or a step), whichever path of the
program runs it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# contact terms: per unordered pair the shared part 18 (difference 2,
# squared distance 3, rsqrt and distance 2, penetration softplus 6, scale
# 5), per direction the force accumulation 4
PAIR_SHARED_OPS, PAIR_DIR_OPS = 18, 4
# reward statistics: per (agent, vertex) the squared distance 5 and two
# minima 2; per unordered agent pair the squared distance 5 and the compare
# 1; per direction the count 1
HAUS_OPS, COLL_SHARED_OPS, COLL_DIR_OPS = 7, 6, 1
STEP_OPS = 20  # integration per agent: damping, force / mass, clamp, update
# the in-kernel BFS + ezpolicy of K3 at n = 3^L: per pyramid row the four
# centroids 12; per group of three the members centred 12 and the nine
# squared distances 45; per member 52; per agent the action into the force 4
BFS_ROW_OPS, BFS_GROUP_OPS, BFS_MEMBER_OPS, BFS_FORCE_OPS = 12, 12 + 45, 52, 4
HIDDEN = 64


def bound_s(nbytes: float, ops: float) -> float:
    """The least time in seconds: the larger of the bytes at the HBM rate
    and the operations at the FP32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def mlp_flops(dims) -> int:
    """Multiply-add FLOPs of one row through dense layers of widths ``dims``."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def pair_ops(ordered: int) -> float:
    """Contact terms of ``ordered`` ordered pairs."""
    return ordered / 2 * PAIR_SHARED_OPS + ordered * PAIR_DIR_OPS


def stat_ops(n: int) -> float:
    """One env's reward statistics at n agents."""
    return n * n * HAUS_OPS + n * (n - 1) / 2 * COLL_SHARED_OPS + n * (n - 1) * COLL_DIR_OPS


def env_step_ops(n: int) -> float:
    """One env step after the actions: contacts, reward statistics, integration."""
    return pair_ops(n * (n - 1)) + stat_ops(n) + n * STEP_OPS


def bfs_policy_ops(n: int) -> float:
    """One env's BFS + ezpolicy at n = 3^L agents."""
    rows = (n - 1) // 2
    return rows * (BFS_ROW_OPS + BFS_GROUP_OPS + 3 * BFS_MEMBER_OPS) + n * BFS_FORCE_OPS


# -- the MAPPO networks' forward, per env ---------------------------------------

def actor_first_dense(n: int, H: int = HIDDEN) -> float:
    """The actor's first layer of one env on the 6n-wide observation."""
    return n * mlp_flops((6 * n, H))


def critic_first_dense(n: int, H: int = HIDDEN) -> float:
    """The critic's first layer of one env on the 6n·n-wide observation."""
    return mlp_flops((6 * n * n, H))


def actor_first_factorized(n: int, H: int = HIDDEN) -> float:
    """The actor's first layer of one env by the factorized algebra
    (``models/structured_obs.py: hd_actor_h1``): per agent the difference
    product (p_k - p_{k+1}) W~[k] 2·2H, the prefix sum H, p_i U 2·2H,
    v_i Wv 2·2H and three adds 3H; per env TOT (n-1)·2·2H, the shape and
    velocity products 2n·2H + 2·2H and the neighbour differences 2(n-1)."""
    per_agent = 3 * 4 * H + H + 3 * H
    return n * per_agent + (n - 1) * 4 * H + 2 * n * 2 * H + 4 * H + 2 * (n - 1)


def critic_first_factorized(n: int, H: int = HIDDEN) -> float:
    """The critic's first layer of one env by the factorized algebra
    (``hd_critic_h1``): four products of a 2n-wide row (velocities, V,
    U, the shape) 4·2n·2H, the velocity 2·2H and five adds 5H.  The
    parameter-only sums are per forward, not per env, and left out."""
    return 4 * 2 * n * 2 * H + 4 * H + 5 * H


def forward_ops(n: int, factorized: bool, H: int = HIDDEN) -> float:
    """Actor (n rows) and critic (one row) forward of one env."""
    a1 = actor_first_factorized(n, H) if factorized else actor_first_dense(n, H)
    c1 = critic_first_factorized(n, H) if factorized else critic_first_dense(n, H)
    tail_a = n * (mlp_flops((H, H, 2)) + 2 * H)  # the rest of the trunk, relu included
    tail_c = mlp_flops((H, H, 1)) + 2 * H
    return a1 + c1 + tail_a + tail_c


def iteration_ops(n: int, num_envs: int, rollout_len: int, epochs: int, factorized: bool) -> float:
    """One MAPPO iteration: ``rollout_len`` env steps and forwards of every
    env, the last value, and each epoch's forward and backward (twice the
    forward) over every sample."""
    f = forward_ops(n, factorized)
    samples = num_envs * rollout_len
    return samples * (env_step_ops(n) + f) + num_envs * f + epochs * 3 * samples * f


def rollout_step_ops(n: int, num_envs: int) -> float:
    """One step of the fused BFS rollout (K3): the policy and the env step."""
    return num_envs * (env_step_ops(n) + bfs_policy_ops(n))


# -- each kernel's least time for one launch ----------------------------------

def k1_bound_s(n: int, B: int) -> float:
    """K1 (``pairforce_sym``): positions in, forces out."""
    return bound_s(16 * B * n, B * pair_ops(n * (n - 1)))


def k2_bound_s(n: int, B: int) -> float:
    """K2 (``reward_sym``) over every env: positions and shape in, the
    Hausdorff distance and the counts out."""
    return bound_s(16 * B * n + 4 * B + 4 * B * n, B * stat_ops(n))


def k3_bound_s(n: int, B: int) -> float:
    """K3 (``fused_step``) with the in-kernel BFS."""
    return bound_s(44 * B * n + 12 * B, B * (env_step_ops(n) + bfs_policy_ops(n)))


def k5_bound_s(n: int, B: int, T: int) -> float:
    """K5 (``fused_collect``): the state in and out, and the trajectory."""
    soa = 8 * (6 * n + 3)
    traj = 4 * T * (6 * n * n + 3 * n + 3)
    actor, critic = mlp_flops((6 * n, HIDDEN, HIDDEN, 2)), mlp_flops((6 * n * n, HIDDEN, HIDDEN, 1))
    return bound_s(B * (soa + traj), B * T * (n * actor + critic + env_step_ops(n)))


def k9_bound_s(n: int, M: int) -> float:
    """K9 (``fused_ppo_grad``), one epoch over M samples: the forward, the
    weight gradients (as many multiply-adds as the forward) and the input
    gradients of the two hidden layers."""
    actor, critic = mlp_flops((6 * n, HIDDEN, HIDDEN, 2)), mlp_flops((6 * n * n, HIDDEN, HIDDEN, 1))
    ops = M * (n * (2 * actor + mlp_flops((HIDDEN, HIDDEN, 2))) + 2 * critic + mlp_flops((HIDDEN, HIDDEN, 1)))
    return bound_s(4 * M * (6 * n * n + 3 * n + 3), ops)
