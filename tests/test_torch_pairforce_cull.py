"""K8, the culled pair-force kernel (gym_formation_tpu_torch/ops/kernels/
pairforce_cull.py): the Morton sort of its plain version held bit for bit
against the JAX package's, the plain version against the JAX culled kernel
in interpret mode, the dense kernel and a float64 oracle, on the same numpy
inputs; the card kernel's grid of cells (grid_cells_plain, in the kernel's
float32 arithmetic) on adversarial fixtures, and its exactness.  The
pair-plane plain versions call no MKL vector-math operation, and the plain
K8's first call in a fresh process gives the bits of its later calls."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gym_formation_tpu.core import make_world_cfg as j_make_world_cfg
from gym_formation_tpu.ops.pallas import collision_forces_batched as j_dense
from gym_formation_tpu.ops.pallas import collision_forces_culled as j_culled
from gym_formation_tpu.ops.pallas import morton_order as j_morton

from gym_formation_tpu_torch.core import make_world_cfg
from gym_formation_tpu_torch.ops import pairwise_dists
from gym_formation_tpu_torch.ops.kernels import pairforce, pairforce_cull, pairforce_sym

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


# ATen's CPU kernels that call MKL's vector math library (ATen/cpu/vml.h:
# IMPLEMENT_VML_MKL; pow reaches sqrt's at the exponent 0.5).  The first such
# call of a process, split over the intra-op threads, can give one thread's
# share from a less accurate routine: MKL's lazy set-up races.
_MKL_VML_OPS = {"acos", "asin", "atan", "cos", "erf", "erfc", "erfinv", "exp", "log", "log10", "log2",
                "pow", "sin", "sqrt", "tan", "tanh", "trunc"}


class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func._schema.name.split("::")[-1])
        return func(*args, **(kwargs or {}))


def _pair_plains():
    cfg = make_world_cfg(40, 20, agent_size=0.03, landmark_size=0.01)
    pos = torch.as_tensor(np.random.RandomState(4).uniform(-0.3, 0.3, (2, 60, 2)), dtype=torch.float32)
    return {
        "k8": lambda: pairforce_cull.collision_forces_culled_plain(pos, cfg),
        "k6": lambda: pairforce.collision_forces_batched_plain(pos, cfg),
        "k1": lambda: pairforce_sym.collision_forces_sym_plain(pos, **pairforce_sym._params(cfg)),
        "pairwise_dists": lambda: pairwise_dists(pos, pos),
    }


@pytest.mark.parametrize("name", ["k8", "k6", "k1", "pairwise_dists"])
def test_pair_plains_call_no_mkl_vector_math(name):
    """The cause of the plain K8's first-call flake, pinned: the pair-plane
    plain versions call none of the ATen operations that go through MKL's
    vector math library (their distance is hypot, their softplus ATen's)."""
    with _OpRecorder() as rec:
        _pair_plains()[name]()
    assert "hypot" in rec.ops or name == "k1"
    assert not rec.ops & _MKL_VML_OPS, sorted(rec.ops & _MKL_VML_OPS)


_FIRST_CALL = """
import numpy as np, torch
from gym_formation_tpu_torch.core import make_world_cfg
from gym_formation_tpu_torch.ops.kernels import pairforce_cull
cfg = make_world_cfg(243, 243, agent_size=0.03, landmark_size=0.01)
pos = torch.as_tensor(np.random.RandomState(0).uniform(-0.5, 0.5, (5, 486, 2)).astype(np.float32))
f = [pairforce_cull.collision_forces_culled_plain(pos, cfg) for _ in range(3)]
print(sum(not torch.equal(f[0], g) for g in f[1:]))
"""


def test_k8_plain_first_call_equals_later_calls():
    """In fresh processes (no JAX), the plain K8's first call on hd_case's
    inputs gives the bits of its later calls.  With torch.sqrt and
    torch.exp the MKL race above struck a few processes in a hundred
    (``tools/first_call_probe.py`` counts them); the test above pins the
    cause, this one the symptom."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL], cwd=root, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for _ in range(6)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert out.strip() == "0"


def test_k8_plain_equals_dense_on_spread_positions():
    """tests/test_pallas.py:test_culled_equals_dense_on_spread_positions:
    the card kernel's grid skips some cell pairs in every env, and the result
    is still the dense one."""
    kw = dict(agent_size=0.03, landmark_size=0.01)
    jcfg, tcfg = j_make_world_cfg(128, 128, **kw), make_world_cfg(128, 128, **kw)
    pos = np.random.RandomState(7).uniform(-3.0, 3.0, (4, 256, 2)).astype(np.float32)
    dense = np.asarray(j_dense(jnp.asarray(pos), jcfg, interpret=True))
    culled_j = np.asarray(j_culled(jnp.asarray(pos), jcfg, interpret=True))
    got = pairforce_cull.collision_forces_culled(torch.as_tensor(pos), tcfg).numpy()
    np.testing.assert_allclose(got, dense, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got, culled_j, atol=2e-4, rtol=1e-4)
    cand = pairforce_cull.candidate_pairs_plain(torch.as_tensor(pos), tcfg)
    recv, coll = int((tcfg.collide & tcfg.movable).sum()), int(tcfg.collide.sum())
    assert bool((cand < recv * (coll - 1)).all())  # some pairs are skipped in every env


def _neighbours(cell, dims):
    """[B, E, E]: the two entities' cells at most one column and one row
    apart (entities that collide)."""
    gx = dims[:, :1]
    col, row = cell % gx, cell // gx
    return (((col[:, :, None] - col[:, None, :]).abs() <= 1)
            & ((row[:, :, None] - row[:, None, :]).abs() <= 1))


@pytest.mark.parametrize("spread", [0.5, 3.0])
def test_culled_tile_pairs_add_exact_zeros(spread):
    """The cull's exactness in float32: every pair of colliding entities in
    non-neighbouring cells of the card kernel's grid has a coefficient of
    exactly 0 in the pair arithmetic."""
    cfg = make_world_cfg(243, 3, agent_size=0.03, landmark_size=0.05,
                         landmark_collide=True, landmark_movable=True)
    pos = torch.as_tensor(np.random.RandomState(1).uniform(-spread, spread, (3, 246, 2)), dtype=torch.float32)
    cell, dims = pairforce_cull.grid_cells_plain(pos, cfg)
    far = ~_neighbours(cell, dims)  # every entity collides in this world
    d = torch.cdist(pos, pos)
    z = -(d - 0.1) / cfg.contact_margin  # the largest contact radius of the world
    pen = (z.clamp_min(0.0) + torch.log1p(torch.exp(-z.abs()))) * cfg.contact_margin
    assert far.any() and bool((pen[far] == 0).all())


def _grid_case(name):
    """(cfg, pos [B, E, 2] float32): fixtures that corner the grid."""
    cfg = make_world_cfg(40, 0, agent_size=0.03)
    c, w = pairforce_cull.cutoff(cfg), pairforce_cull._cell_width(cfg)
    rng = np.random.RandomState(len(name))
    pos = rng.uniform(0.0, 12 * w, (3, 40, 2))
    if name == "cell boundaries":
        # points on the cells' edges, and a cutoff (or a hair less) from them
        edge = np.arange(13) * w
        xs = np.concatenate([edge, edge[:9] + c, edge[4:] - c, edge[2:11] + c * (1 - 2**-20)])
        pos[:, :, 0] = xs[:40]
        pos[:, :, 1] = xs[::-1][:40]
    elif name == "box maximum":
        pos[:, 0] = 12 * w  # u = g exactly: clamped into the last cell
        pos[:, 1] = 12 * w - c
    elif name == "one cell":
        pos = rng.uniform(0.0, 0.9 * c, (3, 40, 2))
    elif name == "cell cap":
        pos = rng.uniform(-50 * c, 50 * c, (3, 40, 2))  # 10^4 cells wanted, 2·64 allowed
        pos[0, :, 1] = 0.0  # one row: gx alone hits MAX_AXIS_CELLS
        pos[0, :, 0] = np.linspace(0.0, 2000 * c, 40)
    elif name == "non-colliding":
        cfg = make_world_cfg(20, 20, agent_size=0.03, landmark_size=0.05, landmark_collide=False)
        pos[:, 20:] += 100.0  # far away: the box must not grow
    elif name == "nan":
        pos[0, 3, 0] = np.nan
        pos[1, 5] = np.nan
        pos[2, 7, 1] = np.nan
    return cfg, pos.astype(np.float32)


@pytest.mark.parametrize("name", ["cell boundaries", "box maximum", "one cell", "cell cap", "non-colliding", "nan"])
def test_grid_cells_keep_close_pairs_in_neighbouring_cells(name):
    """The invariant the cull rests on: two colliding entities within the
    cutoff of each other on an axis lie in cells at most one apart on that
    axis; every index stays inside its env's grid (a NaN coordinate too);
    a non-colliding entity has no cell; the grid's cells are at least a
    cutoff wide and at most 2·Ep."""
    cfg, pos = _grid_case(name)
    cell, dims = pairforce_cull.grid_cells_plain(torch.as_tensor(pos), cfg)
    B, E, _ = pos.shape
    gx, gy = dims[:, 0], dims[:, 1]
    assert bool(((gx >= 1) & (gy >= 1) & (gx <= pairforce_cull.MAX_AXIS_CELLS)
                 & (gy <= pairforce_cull.MAX_AXIS_CELLS) & (gx * gy <= 2 * 32 * -(-E // 32))).all())
    coll = torch.as_tensor(cfg.collide)
    assert bool((cell[:, ~coll] == -1).all())
    assert bool(((cell[:, coll] >= 0) & (cell[:, coll] < (gx * gy)[:, None])).all())
    c = pairforce_cull.cutoff(cfg)
    p = torch.as_tensor(pos, dtype=torch.float64)
    ok = coll[:, None] & coll[None, :] & ~torch.isnan(p).any(-1)[:, :, None] & ~torch.isnan(p).any(-1)[:, None, :]
    for axis, (idx, g) in enumerate(((cell % gx[:, None], gx), (cell // gx[:, None], gy))):
        v = torch.where(coll & ~torch.isnan(p[..., axis]), p[..., axis], torch.nan)
        extent = (v.nan_to_num(torch.inf).amin(-1) - v.nan_to_num(-torch.inf).amax(-1)).abs()
        assert bool(((g == 1) | (extent / g >= c)).all())
        close = ok & ((p[:, :, None, axis] - p[:, None, :, axis]).abs() <= c)
        assert bool(((idx[:, :, None] - idx[:, None, :]).abs()[close] <= 1).all())
    if name == "one cell":
        assert bool(((gx == 1) & (gy == 1)).all())
    if name == "cell cap":
        assert int(gx[0]) == 2 * 64  # 1024 halved three times to the cap, 2·Ep
        assert bool((gx * gy > 64).all())
    if name == "non-colliding":
        assert bool((gx * gy > 1).all())  # the far landmarks did not stretch the box


def test_candidate_pairs_cover_near_pairs():
    """Every ordered pair the function needs (i movable and colliding, j
    colliding, within the cutoff) is a candidate: candidate_pairs_plain is
    at least their count and at most every receiver's pairs."""
    cfg = make_world_cfg(60, 40, agent_size=0.05, landmark_size=0.08, landmark_collide=True)
    cfg.movable[90:] = False
    cfg.collide[10:20] = False
    pos = torch.as_tensor(np.random.RandomState(9).uniform(-1.5, 1.5, (4, 100, 2)), dtype=torch.float32)
    cell, dims = pairforce_cull.grid_cells_plain(pos, cfg)
    recv = torch.as_tensor(cfg.collide & cfg.movable)
    part = torch.as_tensor(cfg.collide)
    ok = recv[:, None] & part[None, :] & ~torch.eye(100, dtype=torch.bool)
    dist = torch.cdist(pos.double(), pos.double(), compute_mode="donot_use_mm_for_euclid_dist")
    near = ok & (dist <= pairforce_cull.cutoff(cfg))
    cand = ok & _neighbours(cell, dims)
    assert bool((cand | ~near).all())  # near implies candidate, pair by pair
    got = pairforce_cull.candidate_pairs_plain(pos, cfg)
    assert torch.equal(got, cand.sum((1, 2)))
    assert bool((got >= near.sum((1, 2))).all()) and bool((got < ok.sum()).all())
    assert int(near.sum()) > 0


def test_k8_card_path_is_one_launch_without_a_sort(monkeypatch):
    """On a (simulated) card the wrapper runs no Morton sort and launches
    the one kernel; it admits every entity count up to MAX_ENTITIES, 4800,
    whose layout fits the H100's 227 KB a block, and raises beyond."""
    from test_torch_physics import fake_card

    calls = fake_card(monkeypatch)
    monkeypatch.setattr(pairforce_cull, "morton_order", lambda pos: pytest.fail("sorted on the card path"))
    top = pairforce_cull.MAX_ENTITIES
    assert top >= 1984  # what the kernel held before
    assert pairforce_cull._smem_bytes(top) <= pairforce_cull._SMEM_MAX < pairforce_cull._smem_bytes(top + 1)
    for E in (1, 243, top):
        pairforce_cull.collision_forces_culled(torch.zeros(2, E, 2), make_world_cfg(E, 0, agent_size=0.03),
                                               pairs=torch.zeros(2, dtype=torch.int32))
    assert calls == ["pairforce_cull_launch"] * 3
    with pytest.raises(ValueError, match="at most"):
        pairforce_cull.collision_forces_culled(torch.zeros(1, top + 1, 2), make_world_cfg(top + 1, 0))
    with pytest.raises(ValueError, match="pairs"):
        pairforce_cull.collision_forces_culled(torch.zeros(2, 3, 2), make_world_cfg(3, 0),
                                               pairs=torch.zeros(2, dtype=torch.int64))


def test_k8_plain_matches_k6_plain_on_hd_obs_subset():
    cfg = make_world_cfg(243, 3, agent_size=0.1, landmark_size=0.15,
                         landmark_collide=True, landmark_movable=True)
    pos = torch.as_tensor(np.random.RandomState(2).uniform(-1, 1, (2, 246, 2)), dtype=torch.float32)
    got = pairforce_cull.collision_forces_culled(pos, cfg)
    want = pairforce.collision_forces_batched(pos, cfg)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)
