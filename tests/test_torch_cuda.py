"""The port's CUDA kernels on the card: each kernel against its plain
version at shapes the CPU tests cannot reach (odd sizes, more entities than
threads in a block), the wrappers' input checks, a step of the env and a
fused rollout on the card.  Marked ``cuda``; each test skips where there is no CUDA device.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use.)
"""

import numpy as np
import pytest
import torch

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.core import make_world_cfg
from gym_formation_tpu_torch.envs.formation_hd import FormationHDScenario
from gym_formation_tpu_torch.ops import _build
from gym_formation_tpu_torch.ops.kernels import fused_rollout as k4
from gym_formation_tpu_torch.ops.kernels import fused_step as k3
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


def _all_contact(rng, B, N, box):
    """[B, N, 2] positions in a box of side ``box``, smaller than the contact
    distance over the square root of 2: every pair is in contact, so every
    term of every pair sweep is large."""
    return rng.uniform(0.0, box, (B, N, 2)) - box / 2


# K1 runs the pair sweep of K3 and K6 (tiles of 32): 2 is one pair in a
# diagonal tile; 31, 32, 33 one tile short, exactly, one over; 64 an even
# count of tiles (the last round from one side only), 65 three; 243 eight
# tiles, the last of 19; 1500 47 tiles, more than the 32 warps of a block.
@pytest.mark.parametrize("E", [2, 31, 32, 33, 64, 65, 243, 1500])
def test_k1_every_pair_in_contact(dev, E):
    """Every entity within 0.04 of every other (the contact distance is
    0.06): every pair's term is large, so a pair the sweep skipped or took
    twice would show far beyond atol = rtol = 1e-3."""
    cfg = make_world_cfg(E, 0, agent_size=0.03)
    pos = torch.as_tensor(_all_contact(np.random.RandomState(E), 3, E, 0.04), dtype=torch.float32, device=dev)
    got = k1.collision_forces_sym(pos, cfg)
    want = k1.collision_forces_sym_plain(pos, **k1._params(cfg))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def test_k1_is_deterministic(dev):
    """Two launches on the same inputs give the same bits (the pair sweep's
    sums go in a fixed order): E=243 and E=1500, many pairs in contact."""
    for E in (243, 1500):
        cfg = make_world_cfg(E, 0, agent_size=0.03)
        pos = torch.as_tensor(np.random.RandomState(E).uniform(-0.15, 0.15, (4, E, 2)),
                              dtype=torch.float32, device=dev)
        assert torch.equal(k1.collision_forces_sym(pos, cfg), k1.collision_forces_sym(pos, cfg))


@pytest.mark.parametrize("E", [3000, k1.MAX_ENTITIES])
def test_k1_beyond_48kb_of_shared_memory(dev, E):
    """E=3000 takes 72 KB of shared memory and MAX_ENTITIES, 6144, 144 KB:
    both past the default 48 KB, opted in by the launcher."""
    cfg = make_world_cfg(E, 0, agent_size=0.03)
    pos = torch.as_tensor(np.random.RandomState(E).uniform(-1.0, 1.0, (2, E, 2)), dtype=torch.float32, device=dev)
    before = k1.launches
    got = k1.collision_forces_sym(pos, cfg)
    assert k1.launches == before + 1
    want = k1.collision_forces_sym_plain(pos, **k1._params(cfg))
    assert torch.isfinite(got).all() and float(want.abs().max()) > 1.0
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


# K2 takes super-tiles of 256 agents, 16 x 16 a thread: 1 and 2 agents, one
# tile of 16 short, exactly and one over (31, 32, 33), 64, 65, 243 (pads of
# 13), 1100 (five super-tiles, the last ragged).
K2_SIZES = [1, 2, 31, 32, 33, 64, 65, 243, 1100]


@pytest.mark.parametrize("N", K2_SIZES)
def test_k2_every_pair_in_contact(dev, N):
    """Every agent within 0.02 of every other (thresh 0.03): every count is
    N − 1, so a pair the tiles skipped or took twice would show."""
    rng = np.random.RandomState(N)
    apos = torch.as_tensor(_all_contact(rng, 3, N, 0.02), dtype=torch.float32, device=dev)
    ishape = torch.as_tensor(rng.uniform(-1, 1, (3, N, 2)), dtype=torch.float32, device=dev)
    h, nc = k2.hd_reward_stats_sym(apos, ishape, thresh=0.03)
    h_p, nc_p = k2.hd_reward_stats_sym_plain(apos, ishape, thresh=0.03)
    assert bool((nc == N - 1).all())
    assert torch.equal(nc, nc_p)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=0)


def _on_threshold(N, B):
    """[B, N, 2] agents on a line 2⁻⁵ apart, so that d² of neighbours is 2⁻¹⁰
    = thresh² exactly in f32 (not a collision); every third agent moved
    a quarter of the spacing towards its left neighbour (a collision)."""
    x = np.arange(N) * 2.0**-5
    x[::3] -= 2.0**-7
    x[0] = 0.0
    pos = np.zeros((B, N, 2))
    pos[:, :, 0] = x - 2.0
    pos[:, :, 1] = np.arange(B)[:, None] * 0.5
    return pos


@pytest.mark.parametrize("N", K2_SIZES)
def test_k2_pairs_on_the_threshold(dev, N):
    """Neighbours at d² = thresh² exactly do not collide, closer ones do;
    the counts equal the plain version's bit for bit."""
    thresh = 2.0**-5
    apos = torch.as_tensor(_on_threshold(N, 3), dtype=torch.float32, device=dev)
    ishape = torch.as_tensor(np.random.RandomState(N).uniform(-1, 1, (3, N, 2)), dtype=torch.float32, device=dev)
    h, nc = k2.hd_reward_stats_sym(apos, ishape, thresh=thresh)
    h_p, nc_p = k2.hd_reward_stats_sym_plain(apos, ishape, thresh=thresh)
    assert torch.equal(nc, nc_p)
    if N >= 4:
        assert 0 < int(nc.sum()) < 2 * 3 * (N - 1)  # hits, and neighbours on the threshold left out
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=0)


def test_k2_at_max_agents(dev):
    """MAX_AGENTS (6400, at least the 2042 the kernel held before) takes
    225 KB of shared memory, opted in beyond 48 KB; every pair in contact."""
    N = k2.MAX_AGENTS
    assert N >= 2042 and k2._smem_bytes(N) <= 232448
    rng = np.random.RandomState(1)
    apos = torch.as_tensor(_all_contact(rng, 1, N, 0.02), dtype=torch.float32, device=dev)
    ishape = torch.as_tensor(rng.uniform(-1, 1, (1, N, 2)), dtype=torch.float32, device=dev)
    before = k2.launches
    h, nc = k2.hd_reward_stats_sym(apos, ishape, thresh=0.03)
    assert k2.launches == before + 1
    h_p, nc_p = k2.hd_reward_stats_sym_plain(apos, ishape, thresh=0.03)
    assert bool((nc == N - 1).all()) and torch.equal(nc, nc_p)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("which", ["all", "none", "alternate"])
def test_k2_masked_forms(dev, which):
    N, B = 243, 8
    x = _k3_inputs(dev, N, B, 6, squeeze=0.05)
    mask = torch.as_tensor({"all": np.ones(B, bool), "none": np.zeros(B, bool),
                            "alternate": np.arange(B) % 2 == 0}[which], device=dev)
    fb = (torch.full((B,), -1.0, device=dev), torch.full((B, N), -2.0, device=dev))
    got = k2.hd_reward_stats_sym(x["apos"], x["ishape"], thresh=0.03, mask=mask, fallback=fb)
    want = k2.hd_reward_stats_sym_plain(x["apos"], x["ishape"], thresh=0.03, mask=mask, fallback=fb)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][~mask], fb[0][~mask]) and torch.equal(got[1][~mask], fb[1][~mask])


def test_k2_is_deterministic(dev):
    """Two launches give the same bits (the minima and counts are merged by
    integer atomics, exact in any order): N=243 and 1100, many collisions."""
    for N in (243, 1100):
        rng = np.random.RandomState(N)
        apos = torch.as_tensor(rng.uniform(-0.3, 0.3, (4, N, 2)), dtype=torch.float32, device=dev)
        ishape = torch.as_tensor(rng.uniform(-1, 1, (4, N, 2)), dtype=torch.float32, device=dev)
        one = k2.hd_reward_stats_sym(apos, ishape, thresh=0.03)
        two = k2.hd_reward_stats_sym(apos, ishape, thresh=0.03)
        assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


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


def _k3_inputs(dev, N, B, seed, squeeze=0.3):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    ishape = rng.uniform(-1, 1, (B, N, 2))
    return dict(
        apos=t(rng.uniform(-1, 1, (B, N, 2)) * squeeze),
        avel=t(rng.uniform(-0.5, 0.5, (B, N, 2))),
        aforce=t(rng.uniform(-5, 5, (B, N, 2))),
        ishape=t(ishape - ishape.mean(1, keepdims=True)),
        ideal_vel=t(rng.uniform(-1, 1, (B, 2))),
    )


def _k3_check(got, want):
    """pos, vel, haus to the tolerances of tests/test_fused_step.py; the
    counts exact."""
    torch.testing.assert_close(got[0], want[0], atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(got[1], want[1], atol=2e-3, rtol=1e-4)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=0)
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("stats", ["pre", "post"])
@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("N", [1, 5, 100, 243])
def test_k3_external_matches_plain(dev, N, B, stats):
    x = _k3_inputs(dev, N, B, N)
    cfg = make_world_cfg(N, 0, agent_size=0.03, agent_max_speed=1.0 if N == 100 else None)
    args = (x["apos"], x["avel"], x["aforce"], x["ishape"], cfg)
    got = k3.fused_hd_step(*args, thresh=0.03, stats=stats)
    want = k3.fused_hd_step_plain(*args, thresh=0.03, stats=stats)
    _k3_check(got, want)


@pytest.mark.parametrize("stats", ["pre", "post"])
@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("L", [1, 3, 5])
def test_k3_bfs_matches_plain(dev, L, B, stats):
    """The in-kernel policy rounds as the plain one, so its actions, and
    with them the step, agree to the step's own tolerances."""
    N = 3**L
    x = _k3_inputs(dev, N, B, 100 + N)
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    kw = dict(thresh=0.03, stats=stats, bfs_L=L, ideal_vel=x["ideal_vel"], act_scale=5.0)
    got = k3.fused_hd_step(x["apos"], x["avel"], None, x["ishape"], cfg, **kw)
    want = k3.fused_hd_step_plain(x["apos"], x["avel"], None, x["ishape"], cfg, **kw)
    _k3_check(got, want)


def test_k3_reads_a_strided_agent_slice(dev):
    """The fused rollout hands K3 the agents' rows out of all entities."""
    N, B = 27, 5
    x = _k3_inputs(dev, N, B, 3)
    pos = torch.cat([x["apos"], torch.zeros_like(x["apos"])], 1)
    vel = torch.cat([x["avel"], torch.zeros_like(x["avel"])], 1)
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    got = k3.fused_hd_step(pos[:, :N], vel[:, :N], x["aforce"], x["ishape"], cfg, thresh=0.03)
    want = k3.fused_hd_step(x["apos"], x["avel"], x["aforce"], x["ishape"], cfg, thresh=0.03)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# The pair sweep takes tiles of 32: 31, 32 and 33 agents fill one tile short,
# exactly, and one over (a second tile of one agent); 64 is an even count of
# tiles, whose last round takes each tile pair from one side only; 65 three
# tiles; 243 eight tiles, the last one of 19 agents; 1100 35 tiles, more than
# the 32 warps of a block, in more than 48 KB of shared memory.
@pytest.mark.parametrize("stats", ["pre", "post"])
@pytest.mark.parametrize("N,policy", [(31, "external"), (32, "external"), (33, "external"), (64, "external"),
                                      (65, "external"), (243, "external"), (243, "bfs_ez"), (1100, "external")])
def test_k3_every_pair_in_contact(dev, N, policy, stats):
    """All agents within 0.04 of each other (the contact distance is 0.06):
    a pair the sweep skipped or took twice would move the forces far beyond
    the tolerances of tests/test_fused_step.py, and the collision counts,
    which the sweep carries in pre mode and sweeps again in post mode,
    must be exact.  The in-kernel BFS where 3^L = N."""
    x = _k3_inputs(dev, N, 3, 7 * N)
    apos = torch.as_tensor(_all_contact(np.random.RandomState(N), 3, N, 0.04), dtype=torch.float32, device=dev)
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    kw = dict(thresh=0.03, stats=stats)
    if policy == "bfs_ez":
        kw.update(bfs_L=5, ideal_vel=x["ideal_vel"], act_scale=5.0)
    force = None if policy == "bfs_ez" else x["aforce"]
    got = k3.fused_hd_step(apos, x["avel"], force, x["ishape"], cfg, **kw)
    want = k3.fused_hd_step_plain(apos, x["avel"], force, x["ishape"], cfg, **kw)
    _k3_check(got, want)
    if stats == "pre":
        assert int(got[3].sum()) > 0


def test_k3_is_deterministic(dev):
    """Two launches on the same inputs give the same bits: the pair sweep's
    sums go in a fixed order.  N=243 (eight tiles of 32, the last one
    short) and N=1100 (35 tiles, more than the 32 warps of a block), pre and
    post, squeezed so that many pairs are in contact."""
    for N, L in ((243, 5), (1100, None)):
        x = _k3_inputs(dev, N, 5, N, squeeze=0.1)
        cfg = make_world_cfg(N, 0, agent_size=0.03)
        for stats in ("pre", "post"):
            kw = dict(thresh=0.03, stats=stats)
            if L:
                kw.update(bfs_L=L, ideal_vel=x["ideal_vel"], act_scale=5.0)
            force = None if L else x["aforce"]
            one = k3.fused_hd_step(x["apos"], x["avel"], force, x["ishape"], cfg, **kw)
            two = k3.fused_hd_step(x["apos"], x["avel"], force, x["ishape"], cfg, **kw)
            assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_k2_masked_matches_plain(dev):
    N, B = 243, 9
    x = _k3_inputs(dev, N, B, 5, squeeze=0.05)
    mask = torch.as_tensor(np.arange(B) % 3 == 0, device=dev)
    fb = (torch.full((B,), -1.0, device=dev), torch.full((B, N), -2.0, device=dev))
    got = k2.hd_reward_stats_sym(x["apos"], x["ishape"], thresh=0.03, mask=mask, fallback=fb)
    want = k2.hd_reward_stats_sym_plain(x["apos"], x["ishape"], thresh=0.03, mask=mask, fallback=fb)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][~mask], fb[0][~mask])


def _soa(dev, n, B, ep_len, seed):
    rng = np.random.RandomState(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    ish = rng.uniform(-1, 1, (2 * n, B))
    ish[:n] -= ish[:n].mean(0)
    ish[n:] -= ish[n:].mean(0)
    return k4.SoAState(
        ap=f(rng.uniform(-1, 1, (2 * n, B))), av=f(rng.uniform(-0.2, 0.2, (2 * n, B))),
        ishape=f(ish), ivel=f(rng.uniform(-1, 1, (2, B))),
        t=torch.as_tensor(rng.randint(0, ep_len, (1, B)), dtype=torch.int32, device=dev),
    )


@pytest.mark.parametrize("n", [3, 4, 9])
@pytest.mark.parametrize("B", [1, 7])
def test_k4_matches_plain_across_resets(dev, n, B):
    """Tolerances of tests/test_fused_rollout.py; the episode counters and
    the resets' draws exactly."""
    soa = _soa(dev, n, B, 10, n + B)
    kw = dict(length=25, ep_len=10, n=n)
    s_k, r_k = k4.fused_rollout_hd(soa, 11, **kw)
    s_p, r_p = k4.fused_rollout_hd_plain(soa, 11, **kw)
    tol = 1e-5 if n < 9 else 3e-4
    torch.testing.assert_close(r_k, r_p, rtol=5e-6, atol=2e-3)
    for name in ("ap", "av", "ishape", "ivel"):
        torch.testing.assert_close(getattr(s_k, name), getattr(s_p, name), atol=tol, rtol=0)
    assert torch.equal(s_k.t, s_p.t)


def _k4_pair(dev, n, B, seed, T=25, ep_len=10):
    soa = _soa(dev, n, B, ep_len, seed)
    kw = dict(length=T, ep_len=ep_len, n=n)
    return k4.fused_rollout_hd(soa, 11, **kw), k4.fused_rollout_hd_plain(soa, 11, **kw)


@pytest.mark.parametrize("n", [3, 4, 9])
@pytest.mark.parametrize("B", [7, 37, 4096])
def test_k4_equals_plain_bit_for_bit(dev, n, B):
    """Lane groups of n in a warp: every output equal to the plain
    version's, across resets (ep_len 10, 25 steps: every env resets at least
    twice).  B=7 and 37 leave the last warp's groups partly empty; B=4096 is
    the N=3 path's batch."""
    before = k4.launches
    (s_k, r_k), (s_p, r_p) = _k4_pair(dev, n, B, 3 * n + B)
    assert k4.launches == before + 1
    assert torch.equal(r_k, r_p)
    for name in k4.SoAState._fields:
        assert torch.equal(getattr(s_k, name), getattr(s_p, name)), name
    assert bool((s_k.t < 25).all())


@pytest.mark.parametrize("gap", [0.0, 0.13, 0.16])
def test_k4_fallback_step_equals_plain(dev, gap):
    """Agent 1 of every env at ``gap`` from agent 0: a zero distance (the
    root's operand out of the fast path's range), a contact penalty of about
    4e-32 (the division's numerator out of range), one of a subnormal or
    zero.  The warp takes the step on the intrinsics; every output is still
    the plain version's, bit for bit."""
    soa = _soa(dev, 3, 37, 10, 4)
    ap = soa.ap.clone()
    ap[1] = ap[0] + gap
    ap[4] = ap[3]
    soa = soa._replace(ap=ap)
    kw = dict(length=3, ep_len=10, n=3)
    (s_k, r_k), (s_p, r_p) = k4.fused_rollout_hd(soa, 2, **kw), k4.fused_rollout_hd_plain(soa, 2, **kw)
    assert torch.equal(r_k, r_p)
    for name in k4.SoAState._fields:
        assert torch.equal(getattr(s_k, name), getattr(s_p, name)), name


@pytest.mark.parametrize("mode,count", [(0, 1 << 32), (1, 1 << 32), (2, 1 << 32), (3, 1 << 32), (4, 1 << 34),
                                        (5, 1 << 34)])
def test_rn_fast_paths_equal_intrinsics(dev, mode, count):
    """common.cuh's branch-free sqrt and division equal __fsqrt_rn and
    __fdiv_rn wherever their range tests pass: over every float for the root
    (mode 0) and for division by 3, 4 and 9 (modes 1-3), over 2^34 random
    pairs for division (mode 4), and over every numerator below 2^-63
    (subnormal and zero quotients) by 16 divisors (mode 5)."""
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    lib, stream = _build.lib(), torch.cuda.current_stream(dev).cuda_stream
    for off in range(0, count, 1 << 31):
        _build.check(lib.rn_fast_check_launch(mode, off, min(1 << 31, count - off), out.data_ptr(), stream),
                     "rn_fast_check")
    bad, in_range = out.tolist()
    assert bad == 0 and in_range > count // 3, (bad, in_range)


def test_k4_plan_and_refusal(dev):
    """The occupancy API gives blocks an SM for each built plan; the
    launcher refuses a plan it was not built for, and launches nothing."""
    lib = _build.lib()
    for n in k4.KERNEL_AGENTS:
        G, threads = k4.launch_plan(n)
        assert lib.fused_rollout_plan(n, G, threads) >= 1
        assert lib.fused_rollout_plan(n, G + 1, threads) == -2
        assert lib.fused_rollout_plan(n, G, 2 * threads) == -2
    assert lib.fused_rollout_plan(5, 6, 64) == -2
    soa = _soa(dev, 3, 8, 10, 0)
    out = k4.SoAState(*(torch.empty_like(t) for t in soa))
    rew = torch.empty(8, device=dev)
    G, threads = k4.launch_plan(3)
    for g, th, n in ((G - 1, threads, 3), (G, 32, 3), (G, threads, 5)):
        rc = lib.fused_rollout_launch(*(t.data_ptr() for t in soa), *(t.data_ptr() for t in out), rew.data_ptr(),
                                      8, n, 2, 10, g, th, 1, 0, 5.0, 0.06, 9e-4, 100.0, 1e-3, 1e3, 0.75, 0.1,
                                      torch.cuda.current_stream(dev).cuda_stream)
        assert rc != 0, (g, th, n)


def test_k3_k4_wrappers_reject_bad_inputs(dev):
    x = _k3_inputs(dev, 9, 2, 0)
    cfg = make_world_cfg(9, 0, agent_size=0.03)
    with pytest.raises(ValueError, match="float32"):
        k3.fused_hd_step(x["apos"].double(), x["avel"], x["aforce"], x["ishape"], cfg, thresh=0.03)
    with pytest.raises(ValueError, match="contiguous"):
        k3.fused_hd_step(x["apos"], x["avel"], x["aforce"].transpose(0, 1).contiguous().transpose(0, 1),
                         x["ishape"], cfg, thresh=0.03)
    with pytest.raises(ValueError, match="shared memory"):
        big = _k3_inputs(dev, 4000, 1, 0)
        k3.fused_hd_step(big["apos"], big["avel"], big["aforce"], big["ishape"],
                         make_world_cfg(4000, 0, agent_size=0.03), thresh=0.03)
    soa = _soa(dev, 5, 4, 10, 0)
    with pytest.raises(ValueError, match="built for n"):
        k4.fused_rollout_hd(soa, 0, length=2, ep_len=10, n=5)
    soa = _soa(dev, 3, 4, 10, 0)
    with pytest.raises(ValueError, match="int32"):
        k4.fused_rollout_hd(soa._replace(t=soa.t.long()), 0, length=2, ep_len=10, n=3)


@pytest.mark.parametrize("stats", ["pre", "post"])
def test_fused_rollout_on_card_launches_k3_and_k2(dev, stats):
    """K3 once a step; K2 (masked) once a step and once to finalize in pre
    mode, never in post mode.  The rewards match the card's step path."""
    n, B, T = 27, 6, 12
    env = gt.FormationEnv(FormationHDScenario(num_agents=n, episode_length=5))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = env.reset_state(g, B)
    before = (k3.launches, k2.launches)
    g.manual_seed(1)
    fin, rew = gt.rollout_statepolicy_fused(env, None, state, g, T, stats=stats, policy="bfs_ez")
    assert (k3.launches - before[0], k2.launches - before[1]) == (T, T + 1 if stats == "pre" else 0)
    pol = lambda s, gen: gt.bfs_actions_from_state(gt.ezpolicy_batched, env.scenario, s, 3)
    g.manual_seed(1)
    ref_fin, ref = gt.rollout_statepolicy(env, pol, state, g, T)
    torch.testing.assert_close(rew, ref.sum(-1), atol=5e-3, rtol=1e-4)
    assert torch.equal(fin.t, ref_fin.t) and rew.device.type == "cuda"


# -- K5, K9 and the MAPPO train step ------------------------------------------

def _networks(n, dev, seed=0):
    from gym_formation_tpu_torch.models.networks import GaussianActor, ValueCritic

    g = torch.Generator()
    g.manual_seed(seed)
    actor = GaussianActor(6 * n, 2, generator=g)
    critic = ValueCritic(6 * n * n, generator=g)
    with torch.no_grad():
        actor.head.weight.mul_(50.0)
        actor.log_std.fill_(-0.5)
    return actor.to(dev), critic.to(dev)


@pytest.mark.parametrize("squeeze", [1.0, 0.02])
@pytest.mark.parametrize("B", [7, 37])
@pytest.mark.parametrize("n", [3, 4, 9])
def test_k5_matches_plain_across_resets(dev, n, B, squeeze):
    """Trajectory and state within atol 1e-4 / 1e-5 (the kernel rounds as
    the plain version, so in practice bit for bit); done and the episode
    counters exact across resets; the squeezed fixture has collisions."""
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5

    soa = _soa(dev, n, B, 10, 3 * n + B)
    soa = soa._replace(ap=(soa.ap * squeeze).contiguous())
    actor, critic = _networks(n, dev, n)
    aops, cops = k5.actor_planes(actor), k5.critic_planes(critic)
    kw = dict(length=25, ep_len=10, n=n)
    before = k5.launches
    s_k, tr_k = k5.fused_collect_hd(soa, aops, cops, 4, **kw)
    assert k5.launches == before + 1
    s_p, tr_p = k5.fused_collect_hd_plain(soa, aops, cops, 4, **kw)
    for name in ("ap", "av", "ishape", "ivel"):
        torch.testing.assert_close(getattr(s_k, name), getattr(s_p, name), atol=1e-5, rtol=0)
    for name in ("obs", "action", "logp", "value", "reward"):
        torch.testing.assert_close(tr_k[name], tr_p[name], atol=1e-4, rtol=1e-5)
    assert torch.equal(s_k.t, s_p.t) and torch.equal(tr_k["done"], tr_p["done"])
    assert bool(tr_k["done"].any(0).all())
    if squeeze < 1.0:
        rel = tr_k["obs"][0, :, :, 2:4]  # agent i to its first neighbour, before the first step
        assert bool((rel.norm(dim=-1) < 0.03).any())


def _k5_pair(dev, n, B, seed):
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5

    soa = _soa(dev, n, B, 10, seed)
    actor, critic = _networks(n, dev, n)
    return k5, soa, k5.actor_planes(actor), k5.critic_planes(critic)


@pytest.mark.parametrize("n", [3, 4, 9])
def test_k5_matches_plain_at_full_batch(dev, n):
    """B = 4096, the training batch: at n=3 256 tiles of 16 in one wave; at
    n=9 1024 tiles of 4 walked by one block an SM (several persistent
    waves).  The gates of test_k5_matches_plain_across_resets."""
    k5, soa, aops, cops = _k5_pair(dev, n, 4096, 5 * n)
    E, _ = k5.launch_plan(n)
    per_sm = k5._blocks_per_sm(n, torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert per_sm == (2 if n == 3 else 1)
    if n == 9:
        assert -(-4096 // E) > 2 * k5.grid_blocks(4096, E, per_sm, sms)  # several tiles a block
    kw = dict(length=25, ep_len=10, n=n)
    s_k, tr_k = k5.fused_collect_hd(soa, aops, cops, 4, **kw)
    s_p, tr_p = k5.fused_collect_hd_plain(soa, aops, cops, 4, **kw)
    for name in ("ap", "av", "ishape", "ivel"):
        torch.testing.assert_close(getattr(s_k, name), getattr(s_p, name), atol=1e-5, rtol=0)
    for name in ("obs", "action", "logp", "value", "reward"):
        torch.testing.assert_close(tr_k[name], tr_p[name], atol=1e-4, rtol=1e-5)
    assert torch.equal(s_k.t, s_p.t) and torch.equal(tr_k["done"], tr_p["done"])
    assert bool(tr_k["done"].any(0).all())


@pytest.mark.parametrize("n,B", [(3, 4096), (9, 1100)])
def test_k5_is_deterministic(dev, n, B):
    """Two launches give the same bits: no sum depends on the schedule."""
    k5, soa, aops, cops = _k5_pair(dev, n, B, 1)
    kw = dict(length=25, ep_len=10, n=n)
    (s1, t1), (s2, t2) = (k5.fused_collect_hd(soa, aops, cops, 8, **kw) for _ in range(2))
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    for k in t1:
        assert torch.equal(t1[k], t2[k]), k


def _k9_data(dev, num_envs, T=8, n=3):
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig

    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=n),
                 MAPPOConfig(rollout_len=T, fused_update=True), num_envs=num_envs, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    ts, es, obs = algo.init(g)
    collect = algo._collect_fused if algo.fused_collect else algo._collect  # K5 holds n=3 only
    with torch.no_grad():
        es, obs, traj, _, last = collect(ts, es, obs, g)
    ts, data = algo._prepare(ts, traj, last)
    return algo, ts, data


# n = 5, 6, 7 give the critic rows of 150, 216 and 294 floats: dW1 in
# groups of 128 rows (the kernel's wide form)
@pytest.mark.parametrize("num_envs,n", [(37, 3), (512, 3), (64, 5), (32, 6), (16, 7)])
def test_k9_matches_plain_and_autograd(dev, num_envs, n):
    """Every gradient leaf against the plain version and the learner's
    epoch gradient against autograd of the loss (rtol 2e-3, atol 2e-6, the
    tolerance of tests/test_fused_ppo_grad.py); M = 296 leaves a ragged
    last chunk.  Two runs agree bit for bit."""
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9

    algo, ts, data = _k9_data(dev, num_envs, n=n)
    f = lambda t: t.detach().float().contiguous()
    (a1, a2), (c1, c2) = ts.actor.mlp.layers, ts.critic.mlp.layers
    aops = (f(a1.weight.T), f(a1.bias), f(a2.weight.T), f(a2.bias), f(ts.actor.head.weight.T),
            f(ts.actor.head.bias), f(ts.actor.bounded_log_std()))
    cops = (f(c1.weight.T), f(c1.bias), f(c2.weight.T), f(c2.bias), f(ts.critic.head.weight.T),
            f(ts.critic.head.bias))
    sub = {k: data[k] for k in ("obs", "action", "logp", "adv", "value", "target")}
    kw = dict(n_agents=n, act_dim=2, clip_eps=0.2, huber_delta=10.0, value_coef=1.0)
    got = k9.fused_ppo_grads(sub, aops, cops, **kw)
    want = k9.fused_ppo_grads_plain(sub, aops, cops, **kw)
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(x, y, rtol=2e-3, atol=2e-6)
    M = data["obs"].shape[0]
    per_row = torch.tensor([n * M, M, n * M], dtype=torch.float32, device=dev)
    torch.testing.assert_close(got[2] / per_row, want[2] / per_row, rtol=2e-3, atol=1e-6)
    again = k9.fused_ppo_grads(sub, aops, cops, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got[0] + got[1], again[0] + again[1]))
    grads, _ = algo._fused_epoch_grads(ts, data)
    total, _ = algo._loss(ts, data, ts.value_norm)
    for x, y in zip(grads, torch.autograd.grad(total, ts.params())):
        torch.testing.assert_close(x, y, rtol=2e-3, atol=2e-6)


def _k9_synthetic(dev, M, n, A, seed):
    """K9's operands and a batch made on the card from a seed: networks at
    their init scale (head gain raised), actions drawn around the actor's
    mean, old log-probs, values and targets perturbed so that the clips of
    both losses bind on some rows."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    do, dc, H = 6 * n, 6 * n * n, 64
    w = lambda i, o, gain=1.0: (rn(i, o) * gain / i**0.5).contiguous()
    aops = (w(do, H), 0.1 * rn(H), w(H, H), 0.1 * rn(H), w(H, A, 5.0), 0.1 * rn(A), -0.5 + 0.1 * rn(A))
    cops = (w(dc, H), 0.1 * rn(H), w(H, H), 0.1 * rn(H), w(H, 1), 0.1 * rn(1))
    obs = 1.5 * rn(M, n, do)
    relu = torch.relu
    mean = relu(relu(obs @ aops[0] + aops[1]) @ aops[2] + aops[3]) @ aops[4] + aops[5]
    act = mean + aops[6].exp() * rn(M, n, A)
    z = (act - mean) / aops[6].exp()
    logp = -0.5 * (z * z).sum(-1) - aops[6].sum() - 0.5 * A * float(np.log(2 * np.pi)) + 0.2 * rn(M, n)
    value = (relu(relu(obs.reshape(M, -1) @ cops[0] + cops[1]) @ cops[2] + cops[3]) @ cops[4] + cops[5])[:, 0]
    data = {"obs": obs, "action": act.contiguous(), "logp": logp.contiguous(), "adv": rn(M),
            "value": value.contiguous(), "target": (value + rn(M)).contiguous()}
    return data, aops, cops


# M = 8 gives 24 actor rows and 8 critic rows: fewer than one chunk a block;
# 777 and 4097 leave a ragged last chunk; n = 4 widens the critic's rows to
# 96 (the kernel's widest dW1 tiles), n = 5..8 to 150..384 (dW1 in groups of
# 128 rows; 8 with M = 64: one critic chunk); A = 1 the
# one-dimensional policy.
@pytest.mark.parametrize("M,n,A", [(8, 3, 2), (777, 3, 2), (777, 3, 1), (4097, 4, 2), (1000, 4, 1),
                                   (40000, 3, 2), (777, 5, 2), (300, 6, 1), (3001, 7, 2), (64, 8, 2)])
def test_k9_matches_plain_across_shapes(dev, M, n, A):
    """Every gradient leaf and the metric sums against the plain version
    (rtol 2e-3, atol 2e-6 a leaf); two launches give the same bits."""
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9

    data, aops, cops = _k9_synthetic(dev, M, n, A, M + n + A)
    kw = dict(n_agents=n, act_dim=A, clip_eps=0.2, huber_delta=1.0, value_coef=0.5)
    before = k9.launches
    got = k9.fused_ppo_grads(data, aops, cops, **kw)
    assert k9.launches == before + 1
    want = k9.fused_ppo_grads_plain(data, aops, cops, **kw)
    for i, (x, y) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=2e-3, atol=2e-6, msg=lambda m: f"leaf {i}: {m}")
    per_row = torch.tensor([n * M, M, n * M], dtype=torch.float32, device=dev)
    torch.testing.assert_close(got[2] / per_row, want[2] / per_row, rtol=2e-3, atol=1e-6)
    again = k9.fused_ppo_grads(data, aops, cops, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got[0] + got[1] + (got[2],), again[0] + again[1] + (again[2],)))


def test_k9_shared_memory_and_grid(dev):
    """The launcher's plan: at n=3 two blocks of each role fit an SM (the
    critic's rows of 54 with one stage of input copies), so each launch is
    one wave of two blocks an SM; rows up to 485 floats (n=8: the critic's
    384) fit one block, 486 (n=9) none, and the wrapper raises there."""
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9

    i = dev.index if dev.index is not None else torch.cuda.current_device()
    assert k9._plan(18, True, i) == (2, 2) and k9._plan(54, False, i) == (2, 1)
    for K in (96, 150, 216, 294, 384, 485):
        assert k9._plan(K, False, i)[0] >= 1, K
    assert k9._plan(486, False, i)[0] == 0
    sms = k9._sm_count(dev)
    assert k9._grid(307200, 2, sms) == 2 * sms and k9._grid(102400, 2, sms) == 2 * sms
    data, aops, cops = _k9_synthetic(dev, 4, 9, 2, 0)
    with pytest.raises(ValueError, match="shared memory"):
        k9.fused_ppo_grads(data, aops, cops, n_agents=9, act_dim=2, clip_eps=0.2, huber_delta=1.0,
                           value_coef=0.5)


def test_fused_train_step_card_matches_cpu(dev):
    """One MAPPO iteration with K5 and K9 on the card against the CPU's
    plain versions, from the same networks, state and seed (the slice
    test's tolerances: parameters rtol 5e-3, atol 5e-5; v_loss rtol 1e-3)."""
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig

    rng = np.random.RandomState(4)
    n, B = 3, 64
    apos, ish = rng.uniform(-1, 1, (B, n, 2)), rng.uniform(-1, 1, (B, n, 2))
    ish -= ish.mean(1, keepdims=True)
    st = dict(pos=np.concatenate([apos, ish + apos.mean(1, keepdims=True)], 1), vel=np.zeros((B, 2 * n, 2)),
              c=np.zeros((B, n, 2)), ideal_shape=ish, ideal_vel=rng.uniform(-1, 1, (B, 2)),
              t=rng.randint(0, 5, B).astype(np.int32))
    out = {}
    for d in (dev, torch.device("cpu")):
        algo = MAPPO(gt.make_env("formation_hd_env", num_agents=n, episode_length=6),
                     MAPPOConfig(rollout_len=8, ppo_epochs=2, fused_collect=True, fused_update=True),
                     num_envs=B, device=d)
        ts = algo.init_state(*_networks(n, d, 5))
        algo._next_seed = lambda: 77
        ts, es, obs, m = algo.train_step(ts, gt.state_from_numpy(st, device=d), None, torch.Generator(device=d))
        out[d.type] = ([p.detach().cpu() for p in ts.params()], float(m["v_loss"]), es.t.cpu())
    for x, y in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(x, y, rtol=5e-3, atol=5e-5)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-3 * abs(out["cpu"][1])
    assert torch.equal(out["cuda"][2], out["cpu"][2])


def test_k5_k9_wrappers_reject_bad_inputs(dev):
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9

    actor, critic = _networks(3, dev)
    aops, cops = k5.actor_planes(actor), k5.critic_planes(critic)
    soa = _soa(dev, 3, 4, 10, 0)
    with pytest.raises(ValueError, match="built for n"):
        k5.fused_collect_hd(_soa(dev, 5, 4, 10, 0), aops, cops, 0, length=2, ep_len=10, n=5)
    with pytest.raises(ValueError, match="float32"):
        k5.fused_collect_hd(soa._replace(ap=soa.ap.double()), aops, cops, 0, length=2, ep_len=10, n=3)
    with pytest.raises(ValueError, match="float32"):
        k5.fused_collect_hd(soa, (aops[0].double(),) + aops[1:], cops, 0, length=2, ep_len=10, n=3)
    _, ts, data = _k9_data(dev, 8)
    sub = {k: data[k] for k in ("obs", "action", "logp", "adv", "value", "target")}
    f = lambda t: t.detach().contiguous()
    (a1, a2), (c1, c2) = ts.actor.mlp.layers, ts.critic.mlp.layers
    aops = [f(a1.weight.T), f(a1.bias), f(a2.weight.T), f(a2.bias), f(ts.actor.head.weight.T),
            f(ts.actor.head.bias), f(ts.actor.bounded_log_std())]
    cops = (f(c1.weight.T), f(c1.bias), f(c2.weight.T), f(c2.bias), f(ts.critic.head.weight.T),
            f(ts.critic.head.bias))
    kw = dict(n_agents=3, act_dim=2, clip_eps=0.2, huber_delta=10.0, value_coef=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        k9.fused_ppo_grads(sub, [a1.weight.detach()] + aops[1:], cops, **kw)  # [out, in], not [in, out]
    with pytest.raises(ValueError, match="float32"):
        k9.fused_ppo_grads(dict(sub, obs=sub["obs"].double()), aops, cops, **kw)


# -- K6, K7, K8 and the hd_obs step ------------------------------------------

def _mixed_cfg(E, seed):
    """E entities of two sizes, one mass 2.5 block, an immovable block and a
    non-colliding block (tests/test_pallas.py:65-85 scaled to E)."""
    cfg = make_world_cfg(E // 2, E - E // 2, agent_size=0.1, landmark_size=0.15,
                         landmark_collide=True, landmark_movable=True)
    cfg.mass[: E // 4] = 2.5
    cfg.movable[E - E // 5:] = False
    cfg.collide[E // 3 : E // 3 + E // 6] = False
    return cfg


@pytest.mark.parametrize("E,B", [(1, 3), (2, 1), (37, 7), (246, 5), (1500, 2)])
def test_k6_matches_plain(dev, E, B):
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6

    cfg = _mixed_cfg(E, E)
    pos = np.random.RandomState(E).uniform(-0.6, 0.6, (B, E, 2)).astype(np.float32)
    if E >= 5:  # exact contact and zero distance
        pos[:, 1] = pos[:, 0] + np.float32([0.2, 0.0])
        pos[:, 3] = pos[:, 4]
    pos = torch.as_tensor(pos, device=dev)
    before = k6.launches
    got = k6.collision_forces_batched(pos, cfg)
    assert k6.launches == before + 1
    want = k6.collision_forces_batched_plain(pos, cfg)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


# Tiles of 32: 2 is one pair in a diagonal tile; 31, 32, 33 one tile short,
# exactly, one over; 64 an even count of tiles (the last round from one side
# only), 65 three; 246 eight tiles (the hd_obs subset at N=243), the last of
# 22; 1500 47 tiles, more than the 32 warps of a block.
@pytest.mark.parametrize("E", [2, 31, 32, 33, 64, 65, 246, 1500])
def test_k6_every_pair_in_contact(dev, E):
    """The mixed cfg with every entity within 0.12 of every other (the
    contact distances are 0.2 to 0.3): every pair's term is large, so a pair
    the sweep skipped or took twice would show far beyond atol = rtol =
    1e-3.  Immovable and non-colliding entities keep their weights."""
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6

    cfg = _mixed_cfg(E, E)
    pos = torch.as_tensor(_all_contact(np.random.RandomState(E), 3, E, 0.12), dtype=torch.float32, device=dev)
    got = k6.collision_forces_batched(pos, cfg)
    want = k6.collision_forces_batched_plain(pos, cfg)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def test_k6_is_deterministic(dev):
    """Two launches on the same inputs give the same bits (the pair sweep's
    sums go in a fixed order): E=246 (eight tiles) and E=1500 (47 tiles,
    more than the warps of a block), dense, the mixed cfg."""
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6

    for E in (246, 1500):
        cfg = _mixed_cfg(E, E)
        pos = torch.as_tensor(np.random.RandomState(E).uniform(-0.5, 0.5, (4, E, 2)),
                              dtype=torch.float32, device=dev)
        assert torch.equal(k6.collision_forces_batched(pos, cfg), k6.collision_forces_batched(pos, cfg))


@pytest.mark.parametrize("N,B,scale", [(1, 2, 1.0), (5, 3, 0.05), (100, 9, 0.05), (243, 4, 1.0), (1100, 2, 0.05)])
def test_k7_matches_plain_and_k2(dev, N, B, scale):
    from gym_formation_tpu_torch.ops.kernels import reward as k7

    rng = np.random.RandomState(N)
    apos = torch.as_tensor(rng.uniform(-1, 1, (B, N, 2)) * scale, dtype=torch.float32, device=dev)
    ishape = torch.as_tensor(rng.uniform(-1, 1, (B, N, 2)), dtype=torch.float32, device=dev)
    h, nc = k7.hd_reward_stats_batched(apos, ishape, thresh=0.03)
    h_p, nc_p = k7.hd_reward_stats_batched_plain(apos, ishape, thresh=0.03)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=0)
    assert torch.equal(nc, nc_p)
    h2, nc2 = k2.hd_reward_stats_sym(apos, ishape, thresh=0.03)
    torch.testing.assert_close(h, h2, atol=1e-6, rtol=0)
    assert torch.equal(nc, nc2)


@pytest.mark.parametrize("N,B,scale", [(1, 2, 1.0), (5, 3, 0.05), (100, 9, 0.05), (243, 4, 1.0), (1100, 2, 0.05)])
def test_k7_equals_k2_bit_for_bit(dev, N, B, scale):
    """K7 runs K2's register tiles with K2's tile side and shared memory, so
    the two give the same bits (the fixtures of test_k7_matches_plain_and_k2)."""
    from gym_formation_tpu_torch.ops.kernels import reward as k7

    rng = np.random.RandomState(N)
    apos = torch.as_tensor(rng.uniform(-1, 1, (B, N, 2)) * scale, dtype=torch.float32, device=dev)
    ishape = torch.as_tensor(rng.uniform(-1, 1, (B, N, 2)), dtype=torch.float32, device=dev)
    h, nc = k7.hd_reward_stats_batched(apos, ishape, thresh=0.03)
    h2, nc2 = k2.hd_reward_stats_sym(apos, ishape, thresh=0.03)
    assert torch.equal(h, h2) and torch.equal(nc, nc2)


def test_k7_at_max_agents(dev):
    """K2's limit, 6400 agents (K7 held 1750 in 48 KB before): 225 KB of
    shared memory, opted in beyond 48 KB; against plain and K2."""
    from gym_formation_tpu_torch.ops.kernels import reward as k7

    N = k7.MAX_AGENTS
    rng = np.random.RandomState(0)
    apos = torch.as_tensor(rng.uniform(-1, 1, (2, N, 2)) * 0.3, dtype=torch.float32, device=dev)
    ishape = torch.as_tensor(rng.uniform(-1, 1, (2, N, 2)), dtype=torch.float32, device=dev)
    h, nc = k7.hd_reward_stats_batched(apos, ishape, thresh=0.03)
    h_p, nc_p = k7.hd_reward_stats_batched_plain(apos, ishape, thresh=0.03)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=0)
    assert torch.equal(nc, nc_p) and int(nc.sum()) > 0
    h2, nc2 = k2.hd_reward_stats_sym(apos, ishape, thresh=0.03)
    assert torch.equal(h, h2) and torch.equal(nc, nc2)


def _near_pairs(pos, cfg):
    """[B] int64: the ordered pairs K8's function needs, i != j, i movable
    and colliding, j colliding, at most the cutoff apart."""
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    recv = torch.as_tensor(cfg.collide & cfg.movable, device=pos.device)
    part = torch.as_tensor(cfg.collide, device=pos.device)
    E = pos.shape[1]
    ok = recv[:, None] & part[None, :] & ~torch.eye(E, dtype=torch.bool, device=pos.device)
    dist = lambda p: torch.cdist(p.double(), p.double(), compute_mode="donot_use_mm_for_euclid_dist")
    return torch.cat([(ok & (dist(p) <= k8.cutoff(cfg))).sum((1, 2)) for p in pos.split(64)])


def _k8_check(pos, cfg):
    """K8 against its plain version (1e-3) and K6 (atol 2e-4, rtol 1e-4:
    the sums' order differs); its count of evaluated pairs equals
    candidate_pairs_plain's and is at least the near pairs.  Returns the
    forces and the count."""
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    pairs = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    before = k8.launches
    got = k8.collision_forces_culled(pos, cfg, pairs=pairs)
    assert k8.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, k8.collision_forces_culled_plain(pos, cfg), atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(got, k6.collision_forces_batched(pos, cfg), atol=2e-4, rtol=1e-4)
    assert torch.equal(pairs.long(), k8.candidate_pairs_plain(pos, cfg))
    assert bool((pairs.long() >= _near_pairs(pos, cfg)).all())
    return got, pairs


# spread: dense (about 250 entities a unit square, the hd_obs density at
# N=243: a grid of 2 x 2 cells) and spread out (most cell pairs culled)
@pytest.mark.parametrize("E,B,spread", [(1, 2, 0.5), (33, 3, 0.5), (33, 3, 3.0), (246, 5, 0.5),
                                        (246, 5, 3.0), (1500, 2, 1.25), (1500, 2, 7.5)])
def test_k8_matches_plain_and_k6(dev, E, B, spread):
    """The mixed world (two sizes, heavy, immovable and non-colliding
    blocks): K8 against its plain version and K6; its evaluated pairs
    against the plain grid's candidates."""
    cfg = _mixed_cfg(E, E + 1)
    pos = torch.as_tensor(np.random.RandomState(E).uniform(-spread, spread, (B, E, 2)),
                          dtype=torch.float32, device=dev)
    _k8_check(pos, cfg)


def test_k8_on_a_lattice(dev):
    """61 x 61 entities at 0.9 of the contact distance apart (0.054),
    jittered, over a world about 20 cutoffs wide (0.164 each), each env's
    lattice shifted by a fraction of a cell: every contact crosses cell
    boundaries somewhere."""
    cfg = make_world_cfg(61 * 61, 0, agent_size=0.03)
    rng = np.random.RandomState(11)
    g = (np.arange(61) - 30) * 0.054
    lat = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pos = lat[None] + rng.uniform(-0.005, 0.005, (3, 61 * 61, 2)) + rng.uniform(0, 0.2, (3, 1, 2))
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    got, pairs = _k8_check(pos, cfg)
    assert float(got.abs().max()) > 1.0
    assert int(pairs.max()) < 61 * 61 * (61 * 61 - 1) // 20  # most pairs skipped


def test_k8_is_deterministic(dev):
    """Two launches on the same inputs give the same forces and counts,
    bit for bit: the grid and the sorted order follow from the positions
    alone.  The mixed world, E=246 and E=1500, several cells an axis."""
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    for E, spread in ((246, 2.0), (1500, 2.5)):
        cfg = _mixed_cfg(E, E)
        pos = torch.as_tensor(np.random.RandomState(E).uniform(-spread, spread, (4, E, 2)),
                              dtype=torch.float32, device=dev)
        runs = []
        for _ in range(2):
            pairs = torch.zeros(4, dtype=torch.int32, device=dev)
            runs.append((k8.collision_forces_culled(pos, cfg, pairs=pairs), pairs))
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_k8_at_max_entities(dev):
    """MAX_ENTITIES (4800) of the mixed world: about 225 KB of shared
    memory, opted in by the launcher."""
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    E = k8.MAX_ENTITIES
    cfg = _mixed_cfg(E, 3)
    pos = torch.as_tensor(np.random.RandomState(3).uniform(-3.0, 3.0, (2, E, 2)), dtype=torch.float32, device=dev)
    _k8_check(pos, cfg)


def test_k8_survives_non_finite_entities(dev):
    """A NaN entity in env 0 and an infinite one in env 1 index the grid
    inside its bounds: the launch completes, and env 2, all finite, equals
    the plain version."""
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    cfg = _mixed_cfg(246, 5)
    pos = np.random.RandomState(5).uniform(-2.0, 2.0, (3, 246, 2)).astype(np.float32)
    pos[0, 7] = np.nan
    pos[1, 9, 0] = np.inf
    pos[1, 10, 1] = -np.inf
    pos = torch.as_tensor(pos, device=dev)
    pairs = torch.zeros(3, dtype=torch.int32, device=dev)
    got = k8.collision_forces_culled(pos, cfg, pairs=pairs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[2], k8.collision_forces_culled_plain(pos[2:], cfg)[0], atol=1e-3, rtol=1e-3)
    assert int(pairs[2]) == int(k8.candidate_pairs_plain(pos[2:], cfg)[0])


def test_k8_far_pairs_add_exact_zeros(dev):
    """contact_coef on the card: two entities of size 0.03 (k = 1e-3) at a
    depth w = -m k for m from 30 to 150 and at 1.5 cutoffs, one env each,
    both in one cell, so K8 evaluates the pair (2 ordered pairs an env).
    Below -25 in the exponent 1 + 2^x rounds to 1 and lg2.approx(1) is 0;
    below -126 ex2.approx.ftz is 0: the force is exactly 0 at w = -104 k,
    the cutoff, and beyond, and already from w = -30 k."""
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    cfg = make_world_cfg(2, 0, agent_size=0.03)
    c = k8.cutoff(cfg)
    d = [0.06 + m * 1e-3 for m in (30, 60, 87.4, 104, 105, 150)] + [1.5 * c]
    pos = np.zeros((len(d), 2, 2), np.float32)
    pos[:, 1, 0] = d
    pos[:, :, 1] = 0.37
    pos = torch.as_tensor(pos, device=dev)
    pairs = torch.zeros(len(d), dtype=torch.int32, device=dev)
    got = k8.collision_forces_culled(pos, cfg, pairs=pairs)
    assert bool((pairs == 2).all())
    assert bool((got == 0).all()), got


def test_k8_and_k6_dense_errors_are_rounding(dev):
    """1500 entities in ±0.5 (about 290 contacts a receiver, terms up to 30
    that cancel to forces of a few units): K8 and K6 sum each receiver's
    terms in different orders and differ by more than the atol 2e-4 of the
    cases above.  Each stays within the first-order f32 error bound of its
    sum against the f64 plain version, u · Σ_j w_j |t_j| with u = 2⁻²⁴ and
    w_j = E + 16 + 2(d_j + dmin_j)/k: E − 1 roundings of the running sum,
    a few of the term's own, and the rounding of d and dmin magnified by
    1/k in z.  So the two kernels differ by rounding, within twice that."""
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    E, B = 1500, 2
    cfg = _mixed_cfg(E, E + 1)
    pos = torch.as_tensor(np.random.RandomState(E).uniform(-0.5, 0.5, (B, E, 2)),
                          dtype=torch.float32, device=dev)
    want = k6.collision_forces_batched_plain(pos.double(), cfg)
    # Σ_j w_j |t_j| per receiver and axis, in f64, on the plain version's terms
    pairc, dist_min = (torch.as_tensor(t, device=dev) for t in k6._pair_tables(cfg))
    p = pos.double()
    dxy = p[:, :, None, :] - p[:, None, :, :]  # [B, E, E, 2]
    d = dxy.norm(dim=-1)
    k = cfg.contact_margin
    pen = torch.nn.functional.softplus(-(d - dist_min) / k) * k
    coef = pairc * cfg.contact_force * pen / d.clamp_min(1e-12)
    w = E + 16 + 2 * (d + dist_min) / k
    tol = 2.0 ** -24 * (w[..., None] * (coef[..., None] * dxy).abs()).sum(2)
    got6, got8 = k6.collision_forces_batched(pos, cfg), k8.collision_forces_culled(pos, cfg)
    plain32 = k6.collision_forces_batched_plain(pos, cfg)
    errs = {name: (got.double() - want).abs() for name, got in
            (("K6", got6), ("K8", got8), ("plain f32", plain32))}
    print("\nE=1500 ±0.5 against the f64 plain version: " + ", ".join(
        f"{n} max abs err {float(e.max()):.3e} ({float((e / tol.clamp_min(1e-30)).max()):.2e} of the bound)"
        for n, e in errs.items()) + f"; K8 - K6 {float((got8 - got6).abs().max()):.3e}; "
        f"bound max {float(tol.max()):.3e}, median {float(tol.median()):.3e}")
    assert bool((errs["K6"] <= tol).all()) and bool((errs["K8"] <= tol).all())
    assert bool(((got8 - got6).double().abs() <= 2 * tol).all())


def test_k6_k7_k8_wrappers_reject_bad_inputs(dev):
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8
    from gym_formation_tpu_torch.ops.kernels import reward as k7

    cfg = _mixed_cfg(8, 0)
    pos = torch.zeros(2, 8, 2, device=dev)
    for fn in (k6.collision_forces_batched, k8.collision_forces_culled):
        with pytest.raises(ValueError, match="float32"):
            fn(pos.double(), cfg)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros(2, 16, 2, device=dev)[:, ::2], cfg)
        with pytest.raises(ValueError, match="entities"):
            fn(torch.zeros(2, 9, 2, device=dev), cfg)
    for mod, fn in ((k6, k6.collision_forces_batched), (k8, k8.collision_forces_culled)):
        big = _mixed_cfg(mod.MAX_ENTITIES + 1, 0)
        with pytest.raises(ValueError, match="at most"):
            fn(torch.zeros(1, big.n_entities, 2, device=dev), big)
    with pytest.raises(ValueError, match="pairs"):
        k8.collision_forces_culled(pos, cfg, pairs=torch.zeros(2, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="one shape"):
        k7.hd_reward_stats_batched(pos, torch.zeros(2, 7, 2, device=dev), thresh=0.03)


def test_hd_obs_step_on_card_matches_cpu(dev):
    """formation_hd_obs_env at N=27: K6 once a step and K1 never on the card;
    T=8 steps of the linear policy agree with the CPU's plain path (the
    tolerances of tests/test_torch_env.py)."""
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6

    n, B, T = 27, 3, 8
    env = gt.make_env("formation_hd_obs_env", num_agents=n)
    rng = np.random.RandomState(3)
    E = env.cfg.n_entities
    pos = rng.uniform(-0.5, 0.5, (B, E, 2))
    pos[:, n + 4 :] = pos[:, :3] + 0.1
    st = dict(pos=pos, vel=np.zeros((B, E, 2)), c=np.zeros((B, n, 2)), ideal_shape=np.zeros((B, 7, 2)),
              ideal_vel=np.zeros((B, 2)), t=np.zeros(B, np.int32))
    W = rng.normal(size=(env.scenario.obs_dim, 2)) / np.sqrt(env.scenario.obs_dim)
    out = {}
    for d in (dev, torch.device("cpu")):
        g = torch.Generator(device=d)
        s = env.scenario.pre_obs(gt.state_from_numpy(st, device=d))
        obs = env.scenario.observe(s)
        w = torch.as_tensor(W, dtype=torch.float32, device=d)
        before = (k1.launches, k6.launches)
        rews = []
        for _ in range(T):
            s, o = env.step(s, torch.clamp(obs @ w, -1.0, 1.0), g)
            obs = o.obs
            rews.append(o.reward)
        if d.type == "cuda":
            assert (k1.launches - before[0], k6.launches - before[1]) == (0, T)
        out[d.type] = (s.pos.cpu(), s.vel.cpu(), torch.stack(rews).cpu())
    (cp, cv, cr), (pp, pv, pr) = out["cuda"], out["cpu"]
    torch.testing.assert_close(cp, pp, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(cv, pv, atol=2e-3, rtol=1e-4)
    torch.testing.assert_close(cr, pr, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("B", [128, 512])
def test_k1_k2_at_the_n3_paths_shape(dev, B):
    """The shape every env step of the N=3 on-policy paths gives K1 and K2:
    the hd env's 3 colliding agents (one tile of 32 with 29 empty lanes in
    K1's sweep; K2's R = 2 super-tile of 32 with 29 pads), pairs in exact
    contact, on K2's threshold and at zero distance."""
    from gym_formation_tpu_torch.core.physics import _collide_subset

    _, _, _, cfg = _collide_subset(gt.make_env("formation_hd_env", num_agents=3).cfg)
    rng = np.random.RandomState(B)
    pos = rng.uniform(-0.5, 0.5, (B, 3, 2))
    pos[0::3, 1] = pos[0::3, 0] + [0.06, 0.0]
    pos[1::3, 1] = pos[1::3, 0] + [0.0, 0.03]
    pos[2::3, 2] = pos[2::3, 1]
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    got = k1.collision_forces_sym(pos, cfg)
    torch.testing.assert_close(got, k1.collision_forces_sym_plain(pos, **k1._params(cfg)), atol=1e-3, rtol=1e-3)
    assert torch.equal(got, k1.collision_forces_sym(pos, cfg))
    ish = torch.as_tensor(rng.uniform(-1, 1, (B, 3, 2)), dtype=torch.float32, device=dev)
    h, nc = k2.hd_reward_stats_sym(pos, ish, thresh=0.03)
    h_p, nc_p = k2.hd_reward_stats_sym_plain(pos, ish, thresh=0.03)
    torch.testing.assert_close(h, h_p, atol=1e-5, rtol=0)
    assert torch.equal(nc, nc_p) and int(nc.sum()) > 0


@pytest.mark.parametrize("kind", ["rmappo", "discrete", "separated"])
def test_onpolicy_path_launches_k1_k2_each_env_step(dev, kind):
    """One iteration of each N=3 on-policy path on the card: K1 and K2
    once an env step, K5 and K9 never, finite metrics."""
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig, RMAPPO, RMAPPOConfig
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9

    if kind == "rmappo":
        algo = RMAPPO(gt.make_env("formation_hd_env", num_agents=3, episode_length=5),
                      RMAPPOConfig(rollout_len=10, ppo_epochs=2), num_envs=16, device=dev)
    else:
        algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3, discrete_action=kind == "discrete"),
                     MAPPOConfig(rollout_len=10, ppo_epochs=2, share_policy=kind != "separated"),
                     num_envs=16, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = algo.init(g)
    for m in (k1, k2, k5, k9):
        m.launches = 0
    *state, metrics = algo.train_step(*state, g)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert (k1.launches, k2.launches, k5.launches, k9.launches) == (10, 10, 0, 0)
