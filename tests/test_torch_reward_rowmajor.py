"""K7, the row-major reward-statistics kernel (gym_formation_tpu_torch/ops/
kernels/reward.py): its plain version held against the JAX package's Pallas
kernel in interpret mode and its XLA formulas on the same numpy inputs, and
against K2's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.ops.pallas.reward import hd_reward_stats_batched as j_k7

from gym_formation_tpu_torch.ops.kernels import reward, reward_sym

THRESH = 0.03  # (s1+s2)/2 with agent size 0.03


def _inputs(n, B, seed, scale):
    rng = np.random.RandomState(seed)
    apos = (rng.uniform(-1, 1, (B, n, 2)) * scale).astype(np.float32)
    ishape = rng.uniform(-1, 1, (B, n, 2))
    return apos, (ishape - ishape.mean(1, keepdims=True)).astype(np.float32)


# tests/test_reward_kernel.py:22-42 (N=243 B=4; N=100 B=5, the padded
# shapes) and a squeezed fixture where collisions fire
@pytest.mark.parametrize("n,B,scale", [(243, 4, 1.0), (100, 5, 1.0), (243, 3, 0.05)])
def test_k7_plain_matches_pallas_interpret_and_xla(n, B, scale):
    apos, ishape = _inputs(n, B, n + B, scale)
    scen = ft.make_env("formation_hd_env", num_agents=n).scenario
    h_x, nc_x = jax.vmap(scen._hd_stats_xla)(jnp.asarray(apos), jnp.asarray(ishape))
    h_p, nc_p = j_k7(jnp.asarray(apos), jnp.asarray(ishape), thresh=THRESH, interpret=True)
    h_t, nc_t = reward.hd_reward_stats_batched(torch.as_tensor(apos), torch.as_tensor(ishape), thresh=THRESH)
    for h, nc in ((h_x, nc_x), (h_p, nc_p)):
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h), atol=1e-6)
        np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc))
    if scale < 1.0:
        assert nc_t.sum() > 0  # collisions present


def test_k7_plain_matches_k2_plain():
    """The two layouts compute one function: counts equal, Hausdorff to
    float32 reduction tolerance (tests/test_reward_kernel.py's A/B)."""
    apos, ishape = _inputs(243, 4, 9, 0.1)
    a, s = torch.as_tensor(apos), torch.as_tensor(ishape)
    h7, nc7 = reward.hd_reward_stats_batched(a, s, thresh=THRESH)
    h2, nc2 = reward_sym.hd_reward_stats_sym(a, s, thresh=THRESH)
    assert torch.equal(nc7, nc2) and nc7.sum() > 0
    torch.testing.assert_close(h7, h2, atol=1e-6, rtol=0)


def test_k7_plain_f64():
    apos, ishape = _inputs(27, 3, 4, 0.05)
    scen = ft.make_env("formation_hd_env", num_agents=27).scenario
    a64, s64 = apos.astype(np.float64), ishape.astype(np.float64)
    h_x, nc_x = jax.vmap(scen._hd_stats_xla)(jnp.asarray(a64), jnp.asarray(s64))
    h_t, nc_t = reward.hd_reward_stats_batched(torch.as_tensor(a64), torch.as_tensor(s64), thresh=THRESH)
    assert h_t.dtype == torch.float64
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_x), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc_x))


@pytest.mark.parametrize("lo,hi", [(1, 150), (150, 301)])
def test_k7_launch_plan_is_k2s(monkeypatch, lo, hi):
    """On a (simulated) card K7's wrapper passes its launcher the tile side
    R and the shared bytes that K2's wrapper passes its own, for every N:
    one schedule (tile_schedule_plain, CPU-tested in test_torch_reward.py),
    so the two kernels give the same bits."""
    from test_torch_physics import fake_card

    fake_card(monkeypatch)
    seen = []

    class _Lib:
        def __getattr__(self, name):
            return lambda *args: seen.append((name, args[-5:-2])) or 0

    monkeypatch.setattr(reward._build, "lib", lambda: _Lib())
    for N in range(lo, hi):
        x = torch.zeros(2, N, 2)
        reward.hd_reward_stats_batched(x, x, thresh=THRESH)
        reward_sym.hd_reward_stats_sym(x, x, thresh=THRESH)
        (n7, (N7, R7, smem7)), (n2, (N2, R2, smem2)) = seen[-2:]
        assert (n7, n2) == ("reward_launch", "reward_sym_launch")
        assert N7 == N2 == N and (R7, smem7) == (R2, smem2) == (reward_sym.tile_side(N), reward_sym._smem_bytes(N))


def test_k7_holds_k2s_agent_count(monkeypatch):
    """K7's limit is K2's (6400 agents, from the H100's 227 KB a block);
    beyond it the wrapper raises on a (simulated) card."""
    from test_torch_physics import fake_card

    calls = fake_card(monkeypatch)
    assert reward.MAX_AGENTS == reward_sym.MAX_AGENTS == 6400
    top = reward.MAX_AGENTS
    reward.hd_reward_stats_batched(torch.zeros(1, top, 2), torch.zeros(1, top, 2), thresh=THRESH)
    assert calls == ["reward_launch"]
    with pytest.raises(ValueError, match="at most"):
        reward.hd_reward_stats_batched(torch.zeros(1, top + 1, 2), torch.zeros(1, top + 1, 2), thresh=THRESH)
