"""The port's CUDA kernels on the card: each kernel against its plain
version at shapes the CPU tests cannot reach (odd sizes, more entities than
threads in a block), the wrappers' input checks, and a step of the env on
the card.  Marked ``cuda``; each test skips where there is no CUDA device.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use.)
"""

import numpy as np
import pytest
import torch

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.core import make_world_cfg
from gym_formation_tpu_torch.ops.kernels import pairforce_sym as k1
from gym_formation_tpu_torch.ops.kernels import reward_sym as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("E,B", [(1, 3), (2, 1), (37, 7), (1500, 2)])
def test_k1_matches_plain(dev, E, B):
    cfg = make_world_cfg(E, 0, agent_size=0.03)
    pos = torch.as_tensor(np.random.RandomState(E).uniform(-0.2, 0.2, (B, E, 2)),
                          dtype=torch.float32, device=dev)
    got = k1.collision_forces_sym(pos, cfg)
    want = k1.collision_forces_sym_plain(pos, **k1._params(cfg))
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("N,B", [(1, 2), (5, 3), (100, 9), (1100, 2)])
def test_k2_matches_plain(dev, N, B):
    rng = np.random.RandomState(N)
    apos = torch.as_tensor(rng.uniform(-1, 1, (B, N, 2)) * 0.05, dtype=torch.float32, device=dev)
    ishape = torch.as_tensor(rng.uniform(-1, 1, (B, N, 2)), dtype=torch.float32, device=dev)
    h, nc = k2.hd_reward_stats_sym(apos, ishape, thresh=0.03)
    h_p, nc_p = k2.hd_reward_stats_sym_plain(apos, ishape, thresh=0.03)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=0)
    assert torch.equal(nc, nc_p)


def test_wrappers_reject_bad_inputs(dev):
    cfg = make_world_cfg(8, 0, agent_size=0.03)
    pos = torch.zeros(2, 8, 2, device=dev)
    with pytest.raises(ValueError, match="float32"):
        k1.collision_forces_sym(pos.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        k1.collision_forces_sym(torch.zeros(2, 16, 2, device=dev)[:, ::2], cfg)
    with pytest.raises(ValueError, match="contiguous"):
        k2.hd_reward_stats_sym(torch.zeros(2, 16, 2, device=dev)[:, ::2], pos, thresh=0.03)
    with pytest.raises(ValueError, match="one shape"):
        k2.hd_reward_stats_sym(pos, torch.zeros(2, 7, 2, device=dev), thresh=0.03)


def test_env_step_on_card_launches_both_kernels(dev):
    venv = gt.make_vec_env("formation_hd_env", num_envs=8, num_agents=27, device=dev)
    state, obs = venv.reset()
    before = (k1.launches, k2.launches)
    state, out = venv.step(state, gt.bfs_actions(gt.ezpolicy_batched, obs, 3))
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 1)
    assert out.obs.shape == (8, 27, 162) and out.obs.device.type == "cuda"
    assert torch.isfinite(out.reward).all()
