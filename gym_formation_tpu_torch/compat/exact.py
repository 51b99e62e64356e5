"""Exact-match harness: the original environment's resets and state
injection.

Counterpart of ``gym_formation_tpu/compat/exact.py``.  The original
environment seeds the global numpy MT19937 (default seed 1) and draws each
reset from it in a fixed order.  :func:`host_reset` replays that order with a
``np.random.RandomState``, and :func:`state_from_numpy` loads host arrays of
one env into an :class:`~gym_formation_tpu_torch.core.types.EnvState`: a
batch of one (``[1, ...]``, the shape every entry point of the port takes for
a single env) on ``device``, the card unless ``device="cpu"`` is given.

Not to be confused with :func:`gym_formation_tpu_torch.core.state_from_numpy`,
which loads a whole batched state from a dict of arrays (or a JAX state); this
one builds one env from its positions, as the JAX package's does, less the
PRNG key the port's state has no field for.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _device
from ..core.types import EnvState
from ..envs.scenario import Scenario


def state_from_numpy(
    scenario: Scenario,
    agent_pos: np.ndarray,
    landmark_pos: np.ndarray,
    agent_vel: Optional[np.ndarray] = None,
    landmark_vel: Optional[np.ndarray] = None,
    ideal_shape: Optional[np.ndarray] = None,
    ideal_vel: Optional[np.ndarray] = None,
    t: int = 0,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> EnvState:
    """An :class:`EnvState` of one env (batch axis of 1) on ``device`` (the
    card unless ``device="cpu"`` is given; raises without one) from host
    arrays, e.g. a reset captured from the original environment.  Float
    fields take ``dtype`` (default the scenario's).  The JAX signature less
    its ``key``: the port's state has no PRNG key."""
    cfg = scenario.cfg
    dtype = dtype or scenario.dtype
    device = _device.resolve(device)

    def host(a, *shape):
        return np.zeros(shape) if a is None else np.asarray(a)

    def field(a):
        return torch.as_tensor(a, dtype=dtype, device=device)[None]

    return EnvState(
        pos=field(np.concatenate([host(agent_pos), host(landmark_pos)])),
        vel=field(np.concatenate([host(agent_vel, cfg.n_agents, cfg.dim_p),
                                  host(landmark_vel, cfg.n_landmarks, cfg.dim_p)])),
        c=field(host(None, cfg.n_agents, cfg.dim_c)),
        ideal_shape=field(host(ideal_shape, cfg.n_landmarks, cfg.dim_p)),
        ideal_vel=field(host(ideal_vel, cfg.dim_p)),
        t=torch.full((1,), t, dtype=torch.int32, device=device),
    )


def host_reset(scenario: Scenario, seed: Optional[int] = None, rng=None, device="cuda") -> EnvState:
    """The original environment's reset draws for ``scenario``: one env in
    the scenario's dtype on ``device`` (the card unless ``device="cpu"`` is
    given; raises without one).

    With ``rng`` None, seeds a fresh MT19937 with ``seed`` (default 1, the
    original environment's) and replays each scenario's draw order:

    * formation_hd: per-agent uniform(−1, 1, 2), then per-landmark
      uniform(−1, 1, 2) (the ideal shape is the centred landmark draws),
      then the ideal velocity uniform(−1, 1, 2);
    * basic, partial, partial_range: per-agent draws, then per-landmark;
    * formation_hd_obs: per-agent draws, per-target draws, then per-obstacle
      draws in bands along x, obstacle velocity (0, −1).
    """
    if rng is None:
        rng = np.random.RandomState(1 if seed is None else seed)
    cfg = scenario.cfg
    kw = dict(device=_device.resolve(device))
    apos = np.stack([rng.uniform(-1, 1, cfg.dim_p) for _ in range(cfg.n_agents)])
    name = scenario.name
    if name == "formation_hd_env":
        draws = np.stack([rng.uniform(-1, 1, cfg.dim_p) for _ in range(cfg.n_landmarks)])
        ideal_vel = rng.uniform(-1, 1, cfg.dim_p)
        return state_from_numpy(scenario, apos, draws, ideal_shape=draws - draws.mean(0), ideal_vel=ideal_vel,
                                **kw)
    if name == "formation_hd_obs_env":
        t, o = scenario.num_targets, scenario.num_obstacles
        tpos = np.stack([rng.uniform(-1, 1, cfg.dim_p) for _ in range(t)])
        band = np.linspace(-1.8, 1.8, o + 1)
        opos = np.stack([rng.uniform([band[k], 2.0], [band[k + 1], 2.5]) for k in range(o)])
        lvel = np.zeros((t + o, cfg.dim_p))
        lvel[t:, 1] = -1.0
        return state_from_numpy(scenario, apos, np.concatenate([tpos, opos]), landmark_vel=lvel, **kw)
    lpos = np.stack([rng.uniform(-1, 1, cfg.dim_p) for _ in range(cfg.n_landmarks)])
    return state_from_numpy(scenario, apos, lpos, **kw)
