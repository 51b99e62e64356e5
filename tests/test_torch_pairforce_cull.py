"""K8, the Morton-culled pair-force kernel (gym_formation_tpu_torch/ops/
kernels/pairforce_cull.py): its sort held bit for bit against the JAX
package's, and its plain version against the JAX culled kernel in interpret
mode, the dense kernel and a float64 oracle, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_formation_tpu.core import make_world_cfg as j_make_world_cfg
from gym_formation_tpu.ops.pallas import collision_forces_batched as j_dense
from gym_formation_tpu.ops.pallas import collision_forces_culled as j_culled
from gym_formation_tpu.ops.pallas import morton_order as j_morton

from gym_formation_tpu_torch.core import make_world_cfg
from gym_formation_tpu_torch.ops.kernels import pairforce, pairforce_cull

from test_torch_pairforce import f64_oracle, het_case, hd_case


def test_morton_order_matches_jax():
    """Equal orders, out-of-range coordinates (clipped) and exact ties (the
    stable sort keeps index order) included."""
    rng = np.random.RandomState(0)
    pos = rng.uniform(-5, 5, (6, 300, 2)).astype(np.float32)
    pos[:, 10:20] = pos[:, 5:6]  # ties
    pos[0, :50] = np.float32([4.5, -4.5])
    want = np.asarray(j_morton(jnp.asarray(pos)))
    got = pairforce_cull.morton_order(torch.as_tensor(pos)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [hd_case, het_case])
def test_k8_plain_matches_pallas_interpret_and_oracle(case):
    """tests/test_pallas.py's test_culled_kernel_matches_f64_oracle and
    test_culled_kernel_heterogeneous_entities, at their tolerance."""
    jcfg, tcfg, pos = case()
    want = np.asarray(j_culled(jnp.asarray(pos), jcfg, interpret=True))
    got = pairforce_cull.collision_forces_culled(torch.as_tensor(pos), tcfg).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    for b in range(pos.shape[0]):
        np.testing.assert_allclose(got[b], f64_oracle(pos[b], tcfg), atol=1e-3, rtol=1e-3)


def test_k8_plain_equals_dense_on_spread_positions():
    """tests/test_pallas.py:test_culled_equals_dense_on_spread_positions:
    tile pairs are culled, and the result is still the dense one."""
    kw = dict(agent_size=0.03, landmark_size=0.01)
    jcfg, tcfg = j_make_world_cfg(128, 128, **kw), make_world_cfg(128, 128, **kw)
    pos = np.random.RandomState(7).uniform(-3.0, 3.0, (4, 256, 2)).astype(np.float32)
    dense = np.asarray(j_dense(jnp.asarray(pos), jcfg, interpret=True))
    culled_j = np.asarray(j_culled(jnp.asarray(pos), jcfg, interpret=True))
    got = pairforce_cull.collision_forces_culled(torch.as_tensor(pos), tcfg).numpy()
    np.testing.assert_allclose(got, dense, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got, culled_j, atol=2e-4, rtol=1e-4)
    tiles = pairforce_cull.tile_pairs_plain(torch.as_tensor(pos), tcfg)
    assert int(tiles.max()) < 8 * 8  # some of the 64 tile pairs are culled in every env


@pytest.mark.parametrize("spread", [0.5, 3.0])
def test_culled_tile_pairs_add_exact_zeros(spread):
    """The cull's exactness in float32: every pair of a tile pair that K8
    skips has a coefficient of exactly 0 in the pair arithmetic."""
    cfg = make_world_cfg(243, 3, agent_size=0.1, landmark_size=0.15,
                         landmark_collide=True, landmark_movable=True)
    pos = torch.as_tensor(np.random.RandomState(1).uniform(-spread, spread, (3, 246, 2)), dtype=torch.float32)
    sp = torch.gather(pos, 1, pairforce_cull.morton_order(pos)[..., None].expand(pos.shape))
    T = -(-246 // 32)
    pad = torch.cat([sp, sp[:, -1:].expand(3, T * 32 - 246, 2)], 1)
    lo, hi = pad.reshape(3, T, 32, 2).amin(2), pad.reshape(3, T, 32, 2).amax(2)
    c = torch.tensor(pairforce_cull.cutoff(cfg), dtype=torch.float32)
    near = ((lo[:, None] <= hi[:, :, None] + c) & (hi[:, None] >= lo[:, :, None] - c)).all(-1)
    assert int(near.sum()) == int(pairforce_cull.tile_pairs_plain(pos, cfg).sum())
    tile = torch.arange(246) // 32
    far = ~near[:, tile][:, :, tile]  # [B, E, E] pairs of skipped tile pairs
    d = torch.cdist(sp, sp)
    z = -(d - 0.3) / cfg.contact_margin  # the largest contact radius of the world
    pen = (z.clamp_min(0.0) + torch.log1p(torch.exp(-z.abs()))) * cfg.contact_margin
    assert far.any() and bool((pen[far] == 0).all())


def test_k8_plain_matches_k6_plain_on_hd_obs_subset():
    cfg = make_world_cfg(243, 3, agent_size=0.1, landmark_size=0.15,
                         landmark_collide=True, landmark_movable=True)
    pos = torch.as_tensor(np.random.RandomState(2).uniform(-1, 1, (2, 246, 2)), dtype=torch.float32)
    got = pairforce_cull.collision_forces_culled(pos, cfg)
    want = pairforce.collision_forces_batched(pos, cfg)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)
