"""The port's arity-3 plane BFS + ezpolicy (K3's in-kernel policy, plain
version) held against the JAX package's ``bfs_ez_planes`` on the same numpy
inputs, and against the port's level-batched expansion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_formation_tpu.models.bfs_planes import bfs_ez_planes as j_bfs_ez_planes

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.models.bfs_planes import bfs_ez_planes


def _planes(L, B, seed, dtype=np.float64):
    """Agent positions, a centred ideal shape and a root velocity, as [N, B]
    planes and [B] rows."""
    rng = np.random.RandomState(seed)
    N = 3**L
    px, py = rng.uniform(-1, 1, (2, N, B))
    sx, sy = rng.uniform(-1, 1, (2, N, B))
    sx, sy = sx - sx.mean(0), sy - sy.mean(0)
    rvx, rvy = rng.uniform(-1, 1, (2, B))
    return [a.astype(dtype) for a in (px, py, sx, sy, rvx, rvy)]


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5])
def test_bfs_ez_planes_matches_jax_f64(L):
    """float64 on both sides: the same arithmetic, to 1e-10."""
    planes = _planes(L, 5, L)
    want = j_bfs_ez_planes(*(jnp.asarray(a) for a in planes), L)
    got = bfs_ez_planes(*(torch.as_tensor(a) for a in planes), L)
    for w, g in zip(want, got):
        assert g.dtype == torch.float64 and g.shape == (3**L, 5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)


def test_bfs_ez_planes_ties_match_jax():
    """Built ties: every agent on one point (the pick's first-index rule)
    and a settled formation (agents on their vertices).  A tie resolved
    the other way would move an action by about 0.1; the JAX selection
    matmuls round the sums differently, hence 1e-10 and not equality."""
    L, B = 2, 2
    px, py, sx, sy, rvx, rvy = _planes(L, B, 0)
    px[:, 0] = py[:, 0] = 0.25  # env 0: all agents on one point
    px[:, 1], py[:, 1] = sx[:, 1] + 0.5, sy[:, 1] - 0.125  # env 1: settled
    planes = (px, py, sx, sy, rvx, rvy)
    want = j_bfs_ez_planes(*(jnp.asarray(a) for a in planes), L)
    got = bfs_ez_planes(*(torch.as_tensor(a) for a in planes), L)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("L", [2, 3])
def test_bfs_ez_planes_matches_level_batched_expansion(L):
    """float32 against bfs_actions_from_state(ezpolicy_batched): the same
    actions up to the two forms' rounding (norms against squared distances,
    hierarchical against flat means).  Tolerance of the JAX package's
    test_fused_rollout_inkernel_bfs_matches_step_path."""
    N, B = 3**L, 4
    px, py, sx, sy, rvx, rvy = _planes(L, B, 10 + L, np.float32)
    env = gt.make_env("formation_hd_env", num_agents=N)
    apos = np.stack([px.T, py.T], -1)
    ishape = np.stack([sx.T, sy.T], -1)
    st = dict(
        pos=np.concatenate([apos, ishape + apos.mean(1, keepdims=True)], 1),
        vel=np.zeros((B, 2 * N, 2), np.float32), c=np.zeros((B, N, 2), np.float32),
        ideal_shape=ishape, ideal_vel=np.stack([rvx, rvy], -1), t=np.zeros(B, np.int32),
    )
    want = gt.bfs_actions_from_state(gt.ezpolicy_batched, env.scenario, gt.state_from_numpy(st), 3)
    ax, ay = bfs_ez_planes(*(torch.as_tensor(a) for a in (px, py, sx, sy, rvx, rvy)), L)
    got = torch.stack([ax.T, ay.T], -1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-3, rtol=1e-4)


def test_bfs_ez_planes_rejects_wrong_rows():
    planes = [torch.as_tensor(a) for a in _planes(2, 2, 0)]
    with pytest.raises(ValueError, match="takes 27 rows"):
        bfs_ez_planes(*planes, 3)
