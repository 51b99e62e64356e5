"""K6, the dense pair-force kernel (gym_formation_tpu_torch/ops/kernels/
pairforce.py): its plain version held against the JAX package's Pallas
kernel in interpret mode, its XLA path and a float64 oracle, on the same
numpy inputs; and the physics dispatch of the hd_obs colliding subset."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.core import make_world_cfg as j_make_world_cfg
from gym_formation_tpu.core import physics as jphys
from gym_formation_tpu.ops.pallas import collision_forces_batched as j_dense

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.core import make_world_cfg
from gym_formation_tpu_torch.core import physics as tphys
from gym_formation_tpu_torch.ops.kernels import pairforce


def f64_oracle(pos, cfg):
    """Direct-delta float64 contact forces of one env (tests/test_pallas.py)."""
    pos = np.asarray(pos, np.float64)
    delta = pos[:, None, :] - pos[None, :, :]
    dist = np.sqrt((delta**2).sum(-1))
    dmin = cfg.size[:, None] + cfg.size[None, :]
    k = cfg.contact_margin
    pen = np.logaddexp(0.0, -(dist - dmin) / k) * k
    coef = cfg.contact_force * pen / np.maximum(dist, 1e-12)
    ok = (cfg.collide[:, None] & cfg.collide[None, :] & (cfg.movable[:, None] | cfg.movable[None, :])
          & ~np.eye(len(pos), dtype=bool))
    ratio = np.where(cfg.movable[None, :], cfg.mass[None, :] / cfg.mass[:, None], 1.0)
    w = np.where(ok & cfg.movable[:, None], coef * ratio, 0.0)
    return np.einsum("ij,ijp->ip", w, delta)


def hd_case():
    """tests/test_pallas.py:36-46: the whole N=243 hd world, B=5 (odd)."""
    kw = dict(agent_size=0.03, landmark_size=0.01)
    pos = np.random.RandomState(0).uniform(-0.5, 0.5, (5, 486, 2)).astype(np.float32)
    return j_make_world_cfg(243, 243, **kw), make_world_cfg(243, 243, **kw), pos


def het_case():
    """tests/test_pallas.py:65-85: mass 2.5, an immovable block and a
    non-colliding block."""
    kw = dict(agent_size=0.05, landmark_size=0.04, landmark_collide=True, landmark_movable=True)
    cfgs = [j_make_world_cfg(100, 156, **kw), make_world_cfg(100, 156, **kw)]
    for c in cfgs:
        c.collide[120:180] = False
        c.movable[200:] = False
        c.mass[50:100] = 2.5
    pos = np.random.RandomState(3).uniform(-0.4, 0.4, (3, 256, 2)).astype(np.float32)
    return cfgs[0], cfgs[1], pos


def hd_obs_subset(n):
    """The colliding subset of formation_hd_obs_env: n agents of size 0.1,
    three obstacles of size 0.15 (in both packages)."""
    jscen = ft.make_scenario("formation_hd_obs_env", num_agents=n)
    tscen = gt.make_scenario("formation_hd_obs_env", num_agents=n)
    return jscen.cfg, tscen.cfg, jphys._collide_subset(jscen.cfg)[3], tphys._collide_subset(tscen.cfg)[3]


@pytest.mark.parametrize("case", [hd_case, het_case])
def test_k6_plain_matches_pallas_interpret_and_oracle(case):
    jcfg, tcfg, pos = case()
    want = np.asarray(j_dense(jnp.asarray(pos), jcfg, interpret=True))
    got = pairforce.collision_forces_batched(torch.as_tensor(pos), tcfg).numpy()
    assert np.abs(want).max() > 1.0  # contacts present
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    for b in range(pos.shape[0]):
        np.testing.assert_allclose(got[b], f64_oracle(pos[b], tcfg), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("case", ["het", "hd_obs"])
def test_k6_plain_matches_xla_f64(case):
    if case == "het":
        jcfg, tcfg, pos = het_case()
    else:
        _, _, jcfg, tcfg = hd_obs_subset(27)
        pos = np.random.RandomState(5).uniform(-0.6, 0.6, (3, 30, 2))
    pos = pos.astype(np.float64)
    want = np.asarray(jax.vmap(lambda p: jphys._collision_forces_xla(p, jcfg))(jnp.asarray(pos)))
    got = pairforce.collision_forces_batched_plain(torch.as_tensor(pos), tcfg).numpy()
    assert got.dtype == np.float64 and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_hd_obs_collision_forces_match_jax_f64():
    """The public entry point on the whole hd_obs world: the non-contiguous
    colliding subset (agents, then obstacles past the targets) gathered,
    through K6's plain version, and scattered back."""
    jcfg, tcfg, _, sub = hd_obs_subset(27)
    assert not gt.ops.kernels.pairforce_sym.sym_applicable(sub)
    pos = np.random.RandomState(6).uniform(-0.6, 0.6, (2, jcfg.n_entities, 2))
    want = np.asarray(jax.vmap(lambda p: jphys.collision_forces(p, jcfg))(jnp.asarray(pos)))
    got = tphys.collision_forces(torch.as_tensor(pos), tcfg).numpy()
    assert np.abs(want[:, 27:31]).max() == 0.0  # targets collide with nothing
    assert np.abs(want[:, 31:]).max() > 0.0  # obstacles are pushed
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_k6_zero_distance_and_exact_contact():
    """nan_guard: a pair at zero distance adds (finite) · 0; a pair at exact
    contact (d = s_i + s_j) adds k·log 2 of penetration."""
    cfg = make_world_cfg(4, 0, agent_size=0.1)
    pos = np.array([[[0.0, 0.0], [0.0, 0.0], [0.5, 0.0], [0.7, 0.0]]])
    f = pairforce.collision_forces_batched(torch.as_tensor(pos), cfg).numpy()
    assert np.isfinite(f).all()
    np.testing.assert_allclose(f[0, :2], 0.0, atol=1e-12)
    want = cfg.contact_force * cfg.contact_margin * np.log(2.0)
    np.testing.assert_allclose(f[0, 3], [want, 0.0], rtol=1e-9)
    np.testing.assert_allclose(f[0, 2], [-want, 0.0], rtol=1e-9)


def test_k6_needs_nan_guard():
    import dataclasses

    cfg = dataclasses.replace(make_world_cfg(3, 0), nan_guard=False)
    with pytest.raises(ValueError, match="nan_guard"):
        pairforce.collision_forces_batched(torch.zeros(1, 3, 2), cfg)


def test_k6_wrapper_admits_what_its_shared_memory_holds(monkeypatch):
    """On a (simulated) card the launcher takes every entity count up to
    MAX_ENTITIES, 4800: 12 floats an entity in tiles of 32 and a flag word a
    tile fit the H100's 227 KB a block, one more tile does not; beyond it
    the wrapper raises."""
    from test_torch_physics import fake_card

    calls = fake_card(monkeypatch)
    top = pairforce.MAX_ENTITIES
    assert pairforce._smem_bytes(top) <= pairforce._SMEM_MAX < pairforce._smem_bytes(top + 1)
    assert top >= 2048  # what the kernel held before
    for E in (1, 33, 1500, top):
        pairforce.collision_forces_batched(torch.zeros(1, E, 2), make_world_cfg(E, 0, agent_size=0.03))
    assert calls == ["pairforce_launch"] * 4
    with pytest.raises(ValueError, match="at most"):
        pairforce.collision_forces_batched(torch.zeros(1, top + 1, 2), make_world_cfg(top + 1, 0))
