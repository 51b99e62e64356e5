"""The port's physics (gym_formation_tpu_torch/core/physics.py) and its
pair-force kernel K1's plain version, held against the JAX package on the
same numpy inputs."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_formation_tpu.core import WallCfg as JWallCfg
from gym_formation_tpu.core import make_world_cfg as j_make_world_cfg
from gym_formation_tpu.core import physics as jphys
from gym_formation_tpu.ops.pallas.pairforce_sym import collision_forces_sym as j_sym

from gym_formation_tpu_torch import _device
from gym_formation_tpu_torch.core import WallCfg, make_world_cfg
from gym_formation_tpu_torch.core import physics as tphys
from gym_formation_tpu_torch.ops import _build
from gym_formation_tpu_torch.ops import kernels
from gym_formation_tpu_torch.ops.kernels import pairforce_sym, reward_sym

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, world kwargs, positions, mass edits): the tests/test_physics.py cases
CASES = {
    "newton_third_law": ((2, 1), dict(agent_size=0.1), [[0.0, 0.0], [0.15, 0.0], [50.0, 50.0]], {}),
    "landmark_non_collide": ((2, 1), dict(agent_size=0.1), [[0.0, 0.0], [5.0, 0.0], [0.01, 0.0]], {}),
    "mass_ratio": ((2, 0), dict(agent_size=0.1), [[0.0, 0.0], [0.15, 0.0]], {1: 4.0}),
    "zero_distance": ((2, 1), dict(agent_size=0.1), [[0.0, 0.0], [0.0, 0.0], [5.0, 5.0]], {}),
    "dense_mixed": ((30, 30), dict(agent_size=0.05, landmark_size=0.05,
                                   landmark_collide=True, landmark_movable=True), None, {3: 2.5}),
    "noncontiguous_subset": ((6, 4), dict(agent_size=0.1, landmark_collide=[True, False, True, False],
                                          landmark_movable=[True, True, False, False]), None, {}),
}


def _case(name):
    (na, nl), kw, pos, mass = CASES[name]
    jcfg, tcfg = j_make_world_cfg(na, nl, **kw), make_world_cfg(na, nl, **kw)
    for i, m in mass.items():
        jcfg.mass[i] = m
        tcfg.mass[i] = m
    if pos is None:
        pos = np.random.RandomState(0).uniform(-0.3, 0.3, (na + nl, 2))
    return jcfg, tcfg, np.asarray(pos, np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("nan_guard", [True, False])
def test_collision_forces_plain_matches_xla_f64(name, nan_guard):
    jcfg, tcfg, pos = _case(name)
    jcfg = dataclasses.replace(jcfg, nan_guard=nan_guard)
    tcfg = dataclasses.replace(tcfg, nan_guard=nan_guard)
    want = np.asarray(jphys._collision_forces_xla(jnp.asarray(pos), jcfg))
    got = tphys._collision_forces_plain(torch.as_tensor(pos)[None], tcfg)[0].numpy()
    if name == "zero_distance":
        # guarded: finite; unguarded: the original's 0/0 NaN, in both packages
        assert np.isfinite(want).all() == nan_guard
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10, equal_nan=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_collision_forces_dispatch_matches_jax_f64(name):
    """The public entry point (subset restriction, then K1's plain version
    or the plain dense path) against the JAX package's."""
    jcfg, tcfg, pos = _case(name)
    want = np.asarray(jphys.collision_forces(jnp.asarray(pos), jcfg))
    got = tphys.collision_forces(torch.as_tensor(pos)[None], tcfg)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_walls_match_jax_f64():
    rng = np.random.RandomState(1)
    walls = (dict(orient="V", axis_pos=1.0, endpoints=(-5.0, 5.0), width=0.1),
             dict(orient="H", axis_pos=-0.5, endpoints=(-0.3, 0.4), width=0.2))
    kw = dict(agent_size=0.1, landmark_movable=[True, False, True])
    jcfg = j_make_world_cfg(3, 3, walls=tuple(JWallCfg(**w) for w in walls), **kw)
    tcfg = make_world_cfg(3, 3, walls=tuple(WallCfg(**w) for w in walls), **kw)
    # touching, inside the ends, beyond the ends, and near the corners
    pos = np.concatenate([
        [[0.98, 0.0], [0.0, -0.45], [0.45, -0.52], [-0.35, -0.49], [0.0, 10.0]],
        rng.uniform(-1, 1, (1, 2)),
    ])
    want = np.asarray(jphys.wall_forces(jnp.asarray(pos), jcfg))
    got = tphys.wall_forces(torch.as_tensor(pos)[None], tcfg)[0].numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("max_speed", [None, 0.5])
def test_world_step_matches_jax_f64(max_speed):
    """Action forces, contacts and damped Euler with the speed clamp."""
    rng = np.random.RandomState(2)
    jcfg = j_make_world_cfg(4, 2, agent_size=0.1, agent_max_speed=max_speed)
    tcfg = make_world_cfg(4, 2, agent_size=0.1, agent_max_speed=max_speed)
    B = 3
    pos = rng.uniform(-0.2, 0.2, (B, 6, 2))
    vel = rng.uniform(-0.5, 0.5, (B, 6, 2))
    u = rng.uniform(-20, 20, (B, 4, 2))
    jp, jv = jax.vmap(lambda p, v, a: jphys.world_step(p, v, a, jcfg))(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(u))
    tp, tv = tphys.world_step(torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(u), tcfg)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-10)
    if max_speed is not None:
        assert np.linalg.norm(tv.numpy()[:, :4], axis=-1).max() == pytest.approx(0.5, rel=1e-9)


def _sym_inputs(E, B, seed):
    pos = np.random.RandomState(seed).uniform(-0.5, 0.5, (B, E, 2)).astype(np.float32)
    # exact-contact, deep-penetration and zero-distance pairs
    pos[:, 1] = pos[:, 0] + np.float32([0.04, 0.0])
    pos[:, 2] = pos[:, 0] + np.float32([0.0, 0.0601])
    pos[:, 3] = pos[:, 4]
    return pos


def test_k1_plain_matches_pallas_interpret():
    E, B = 64, 3
    jcfg = j_make_world_cfg(E, 0, agent_size=0.03)
    tcfg = make_world_cfg(E, 0, agent_size=0.03)
    pos = _sym_inputs(E, B, 3)
    want = np.asarray(j_sym(jnp.asarray(pos), jcfg, interpret=True))
    got = pairforce_sym.collision_forces_sym(torch.as_tensor(pos), tcfg).numpy()
    assert np.abs(want).max() > 1.0  # contacts present
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_k1_plain_matches_f64_oracle_at_n243():
    E, B = 243, 2
    jcfg = j_make_world_cfg(E, 0, agent_size=0.03)
    tcfg = make_world_cfg(E, 0, agent_size=0.03)
    pos = _sym_inputs(E, B, 4)
    oracle = np.asarray(jax.vmap(lambda p: jphys._collision_forces_xla(p, jcfg))(
        jnp.asarray(pos, jnp.float64)))
    got = pairforce_sym.collision_forces_sym(torch.as_tensor(pos), tcfg).numpy()
    np.testing.assert_allclose(got, oracle, atol=1e-3, rtol=1e-3)


def test_sym_applicability_gate():
    het = make_world_cfg(100, 156, agent_size=0.05, landmark_size=0.04,
                         landmark_collide=True, landmark_movable=True)
    assert not pairforce_sym.sym_applicable(het)
    uni = make_world_cfg(64, 0, agent_size=0.03)
    assert pairforce_sym.sym_applicable(uni)
    uni.mass[3] = 2.0
    assert not pairforce_sym.sym_applicable(uni)


def test_cpu_tensor_takes_plain_path_without_launch():
    tcfg = make_world_cfg(16, 16, agent_size=0.03, landmark_size=0.01)
    before = (pairforce_sym.launches, reward_sym.launches)
    pos = torch.as_tensor(np.random.RandomState(5).uniform(-0.1, 0.1, (2, 32, 2)), dtype=torch.float32)
    f = tphys.collision_forces(pos, tcfg)
    assert torch.isfinite(f).all() and f.abs().max() > 0
    assert (pairforce_sym.launches, reward_sym.launches) == before


def fake_card(monkeypatch):
    """Simulate a card: the dispatch rule answers 'kernel' and the kernel
    library is a stub whose launchers record their names and return 0.
    The wrappers' launch counters are restored after the test, so that the
    simulated launches do not reach a later test of the process.  Returns
    the list of launcher names called."""
    calls = []

    class _Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append(name) or 0

    for name in kernels.__all__:
        mod = getattr(kernels, name)
        monkeypatch.setattr(mod, "launches", mod.launches)
    monkeypatch.setattr(_device, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "lib", lambda: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    return calls


def test_unsupported_config_on_card_raises(monkeypatch):
    """On a card, a world outside K1's envelope reaches K6's launcher; a
    world with nan_guard=False has no kernel in either package and raises
    instead of running the plain path."""
    calls = fake_card(monkeypatch)
    pos = torch.zeros(1, 3, 2)
    mixed = make_world_cfg(2, 1, agent_size=0.1, landmark_size=0.05, landmark_collide=True)
    tphys.collision_forces(pos, mixed)
    assert calls == ["pairforce_launch"]
    unguarded = dataclasses.replace(make_world_cfg(3, 0), nan_guard=False)
    with pytest.raises(NotImplementedError, match="nan_guard"):
        tphys.collision_forces(pos, unguarded)


def test_k1_wrapper_admits_its_envelope(monkeypatch):
    """On a (simulated) card every uniform world up to MAX_ENTITIES, 6144
    (6 floats an entity in tiles of 32: 144 KB of the H100's 227 KB a
    block), reaches K1's launcher, through the physics' auto selector too;
    beyond it the wrapper raises."""
    calls = fake_card(monkeypatch)
    top = pairforce_sym.MAX_ENTITIES
    assert top >= 6144 and 6 * 4 * 32 * -(-top // 32) <= 232448
    for E in (2, 243, 3000, top):
        tphys.collision_forces(torch.zeros(1, E, 2), make_world_cfg(E, 0, agent_size=0.03))
    assert calls == ["pairforce_sym_launch"] * 4
    with pytest.raises(ValueError, match="at most"):
        pairforce_sym.collision_forces_sym(torch.zeros(1, top + 1, 2), make_world_cfg(top + 1, 0))


def test_use_kernel_rule():
    assert _device.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        _device.use_kernel(torch.zeros(1, device="meta"))


def test_port_imports_no_jax():
    code = (
        "import sys, gym_formation_tpu_torch, gym_formation_tpu_torch.ops._build,"
        " gym_formation_tpu_torch.algos, gym_formation_tpu_torch.train;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'gym_formation_tpu')];"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
