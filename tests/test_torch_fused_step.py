"""The port's fused step K3 (plain version, as the CPU runs it) held against
the JAX package's ``fused_hd_step`` in interpret mode on the same numpy
inputs, at the shapes and tolerances of tests/test_fused_step.py; and K2's
masked form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_formation_tpu.core import make_world_cfg as j_make_world_cfg
from gym_formation_tpu.ops.pallas.fused_step import fused_hd_step as j_fused_hd_step

from gym_formation_tpu_torch.core import make_world_cfg
from gym_formation_tpu_torch.ops.kernels import fused_step, reward_sym

THRESH = 0.03  # (s1+s2)/2 with agent size 0.03


def _fixture(n, B, seed, squeeze=1.0):
    """The distributions of tests/test_fused_step.py:_fixture, drawn with
    numpy: positions in [-1, 1] squeezed, velocities in [-0.5, 0.5], action
    forces in [-5, 5], a centred ideal shape."""
    rng = np.random.RandomState(seed)
    apos = rng.uniform(-1, 1, (B, n, 2)) * squeeze
    avel = rng.uniform(-0.5, 0.5, (B, n, 2))
    aforce = rng.uniform(-5, 5, (B, n, 2))
    ishape = rng.uniform(-1, 1, (B, n, 2))
    ishape -= ishape.mean(1, keepdims=True)
    return [a.astype(np.float32) for a in (apos, avel, aforce, ishape)]


def _both(n, arrays, stats, max_speed=None, **bfs):
    """The same inputs through JAX fused_hd_step(interpret=True) and the
    port's fused_hd_step on CPU tensors; numpy results of each."""
    kw = dict(agent_size=0.03, landmark_size=0.01, agent_max_speed=max_speed)
    jcfg, tcfg = j_make_world_cfg(n, 0, **kw), make_world_cfg(n, 0, **kw)
    jbfs = {k: jnp.asarray(v) if k == "ideal_vel" else v for k, v in bfs.items()}
    tbfs = {k: torch.as_tensor(v) if k == "ideal_vel" else v for k, v in bfs.items()}
    want = j_fused_hd_step(*(jnp.asarray(a) for a in arrays), jcfg,
                           thresh=THRESH, stats=stats, interpret=True, **jbfs)
    got = fused_step.fused_hd_step(*(torch.as_tensor(a) for a in arrays), tcfg,
                                   thresh=THRESH, stats=stats, **tbfs)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _check(want, got):
    """Tolerances of tests/test_fused_step.py; counts exact."""
    (wp, wv, wh, wc), (gp, gv, gh, gc) = want, got
    np.testing.assert_allclose(gp, wp, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(gv, wv, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(gh, wh, atol=1e-5)
    np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("n,B,squeeze", [(243, 3, 0.1), (100, 5, 0.3)])
def test_fused_step_post_matches_jax(n, B, squeeze):
    arrays = _fixture(n, B, n, squeeze)
    want, got = _both(n, arrays, "post")
    _check(want, got)
    assert got[3].sum() > 0  # collisions present


def test_fused_step_pre_matches_jax():
    """stats='pre': the statistics describe the input positions."""
    arrays = _fixture(243, 3, 7, 0.1)
    want, got = _both(243, arrays, "pre")
    _check(want, got)
    assert got[3].sum() > 0
    h_in, nc_in = reward_sym.hd_reward_stats_sym(
        torch.as_tensor(arrays[0]), torch.as_tensor(arrays[3]), thresh=THRESH)
    np.testing.assert_array_equal(got[2], h_in.numpy())
    np.testing.assert_array_equal(got[3], nc_in.numpy())


def test_fused_step_speed_clamp_matches_jax():
    n = 32
    arrays = _fixture(n, 2, 3)
    arrays[2] = arrays[2] * 10.0  # some agents exceed the clamp
    want, got = _both(n, arrays, "post", max_speed=0.5)
    _check(want, got)
    assert np.linalg.norm(got[1], axis=-1).max() <= 0.5 + 1e-5
    assert np.linalg.norm(want[1], axis=-1).max() > 0.49  # the clamp engaged


@pytest.mark.parametrize("stats", ["pre", "post"])
def test_fused_step_inkernel_bfs_matches_jax(stats):
    """bfs_L=3 at N=27: the policy's action forces replace aforce."""
    n, B = 27, 3
    arrays = _fixture(n, B, 27, 0.3)
    ivel = np.random.RandomState(1).uniform(-1, 1, (B, 2)).astype(np.float32)
    want, got = _both(n, arrays, stats, bfs_L=3, ideal_vel=ivel, act_scale=5.0)
    _check(want, got)
    # the external path with the same forces gives the same step
    from gym_formation_tpu_torch.models.bfs_planes import bfs_ez_planes
    apos, avel, _, ishape = (torch.as_tensor(a) for a in arrays)
    ax, ay = bfs_ez_planes(apos[..., 0].T, apos[..., 1].T, ishape[..., 0].T,
                           ishape[..., 1].T, torch.as_tensor(ivel[:, 0]), torch.as_tensor(ivel[:, 1]), 3)
    ext = fused_step.fused_hd_step(apos, avel, 5.0 * torch.stack([ax.T, ay.T], -1), ishape,
                                   make_world_cfg(n, 0, agent_size=0.03), thresh=THRESH, stats=stats)
    for e, g in zip(ext, got):
        np.testing.assert_array_equal(e.numpy(), g)


def test_fused_step_rejects_what_the_jax_entry_asserts():
    n = 9
    apos, avel, aforce, ishape = (torch.as_tensor(a) for a in _fixture(n, 2, 0))
    ok = make_world_cfg(n, 0, agent_size=0.03)
    call = lambda cfg, **kw: fused_step.fused_hd_step(apos, avel, aforce, ishape, cfg, thresh=THRESH, **kw)
    with pytest.raises(ValueError, match="stats"):
        call(ok, stats="mid")
    with pytest.raises(ValueError, match="nan_guard"):
        call(make_world_cfg(n, 0, agent_size=0.03, nan_guard=False))
    with pytest.raises(ValueError, match="uniform"):
        call(make_world_cfg(n, 1, agent_size=0.03))  # a non-movable landmark
    with pytest.raises(ValueError, match="bfs_L"):
        call(ok, bfs_L=3, ideal_vel=torch.zeros(2, 2), act_scale=5.0)  # 27 != 9
    assert fused_step.launches == 0  # the CPU runs the plain version


def test_k2_masked_form():
    """mask True: computed; mask False: the fallback rows, untouched."""
    n, B = 27, 4
    apos, _, _, ishape = (torch.as_tensor(a) for a in _fixture(n, B, 5, 0.05))
    h, nc = reward_sym.hd_reward_stats_sym(apos, ishape, thresh=THRESH)
    fb = (torch.full((B,), -1.0), torch.full((B, n), -2.0))
    mask = torch.tensor([True, False, True, False])
    hm, ncm = reward_sym.hd_reward_stats_sym(apos, ishape, thresh=THRESH, mask=mask, fallback=fb)
    np.testing.assert_array_equal(hm.numpy(), torch.where(mask, h, fb[0]).numpy())
    np.testing.assert_array_equal(ncm.numpy(), torch.where(mask[:, None], nc, fb[1]).numpy())
    assert nc.sum() > 0
    with pytest.raises(ValueError, match="together"):
        reward_sym.hd_reward_stats_sym(apos, ishape, thresh=THRESH, mask=mask)


@pytest.mark.parametrize("N,bfs_L", [(1, None), (243, 5), (1532, None), (2187, 7), (3872, None)])
def test_fused_step_wrapper_admits_what_its_shared_memory_holds(monkeypatch, N, bfs_L):
    """On a (simulated) card the launcher takes every N up to what the H100's
    227 KB a block hold (3872 agents; 1532, the largest N of the earlier
    48 KB layout; 2187 = 3^7 with the in-kernel BFS), and the wrapper raises
    one agent beyond."""
    from test_torch_physics import fake_card

    calls = fake_card(monkeypatch)
    assert fused_step._smem_floats(N, bfs_L is not None) <= fused_step._SMEM_FLOATS

    def step(n):
        z = torch.zeros(1, n, 2)
        kw = dict(bfs_L=bfs_L, ideal_vel=torch.zeros(1, 2), act_scale=5.0) if bfs_L else {}
        return fused_step.fused_hd_step(z, z, None if bfs_L else z, z, make_world_cfg(n, 0, agent_size=0.03),
                                        thresh=THRESH, **kw)

    step(N)
    assert calls == ["fused_step_launch"]
    if N == 3872:
        with pytest.raises(ValueError, match="shared memory"):
            step(N + 1)
