"""Core state and configuration types of the PyTorch port.

The static world description (:class:`WallCfg`, :class:`WorldCfg`,
:func:`make_world_cfg`) is numpy-only and identical to the JAX package's
``core/types.py``.  The dynamic state is a dataclass of batched tensors: every
field carries a leading env-batch axis ``[B, ...]`` where the JAX package
``vmap``-s a single-env pytree.  The JAX state's per-env PRNG key is dropped:
the vectorized env owns one ``torch.Generator`` instead.

:func:`state_from_numpy` / :func:`state_to_numpy` carry a state across the
two packages as numpy arrays, so tests can step both from the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WallCfg:
    """Static wall description.

    ``orient`` 'H' → wall lies along x (parallel dim 0, perpendicular dim 1);
    'V' → along y.
    """

    orient: str = "H"
    axis_pos: float = 0.0
    endpoints: Tuple[float, float] = (-1.0, 1.0)
    width: float = 0.1
    hard: bool = True


@dataclasses.dataclass(frozen=True)
class WorldCfg:
    """Static world/entity configuration: per-entity arrays indexed
    ``[0, n_agents)`` = agents, ``[n_agents, n_entities)`` = landmarks."""

    n_agents: int
    n_landmarks: int
    dim_p: int = 2
    dim_c: int = 2
    dt: float = 0.1
    damping: float = 0.25
    contact_force: float = 100.0
    contact_margin: float = 1e-3
    world_length: int = 50
    collaborative: bool = True
    # Per-entity static properties, shape [n_entities].
    size: np.ndarray = None
    movable: np.ndarray = None
    collide: np.ndarray = None
    mass: np.ndarray = None
    # mass * (accel if accel is not None else 1): force coefficient on the
    # control input.
    act_coef: np.ndarray = None
    max_speed: np.ndarray = None  # np.inf where unset
    u_noise: np.ndarray = None  # [n_agents], 0 where unset
    c_noise: np.ndarray = None  # [n_agents], 0 where unset
    silent: np.ndarray = None  # [n_agents] bool
    # Control sensitivity applied by the env's action decode before the
    # physics' own act_coef factor: 5.0 unless the agent sets ``accel``.
    sensitivity: np.ndarray = None
    u_range: float = 1.0
    walls: Tuple[WallCfg, ...] = ()
    # Guards the 0/0 of two entities at zero separation; False reproduces
    # the NaN of the original environment.
    nan_guard: bool = True

    @property
    def n_entities(self) -> int:
        return self.n_agents + self.n_landmarks

    def has_noise(self) -> bool:
        return bool(np.any(self.u_noise > 0) or np.any(self.c_noise > 0))


def make_world_cfg(
    n_agents: int,
    n_landmarks: int,
    *,
    agent_size: float = 0.05,
    landmark_size=0.05,
    agent_collide: bool = True,
    landmark_collide=False,
    landmark_movable=False,
    agent_accel: Optional[float] = None,
    agent_max_speed: Optional[float] = None,
    silent: bool = True,
    **kw,
) -> WorldCfg:
    """Build a :class:`WorldCfg` from scenario-level scalars.

    ``landmark_size``/``landmark_collide``/``landmark_movable`` may be scalars
    or per-landmark sequences.
    """
    e = n_agents + n_landmarks

    def fill(n, v, dtype=np.float64):
        a = np.asarray(v, dtype=dtype)
        return np.full((n,), a, dtype=dtype) if a.ndim == 0 else a.astype(dtype)

    size = np.concatenate([fill(n_agents, agent_size), fill(n_landmarks, landmark_size)])
    collide = np.concatenate(
        [fill(n_agents, agent_collide, bool), fill(n_landmarks, landmark_collide, bool)]
    )
    movable = np.concatenate(
        [np.ones(n_agents, bool), fill(n_landmarks, landmark_movable, bool)]
    )
    mass = np.ones(e)
    accel = 1.0 if agent_accel is None else agent_accel
    act_coef = mass[:n_agents] * accel
    sensitivity = fill(n_agents, 5.0 if agent_accel is None else agent_accel)
    max_speed = np.full(e, np.inf)
    if agent_max_speed is not None:
        max_speed[:n_agents] = agent_max_speed
    return WorldCfg(
        n_agents=n_agents,
        n_landmarks=n_landmarks,
        size=size,
        movable=movable,
        collide=collide,
        mass=mass,
        act_coef=act_coef,
        max_speed=max_speed,
        u_noise=np.zeros(n_agents),
        c_noise=np.zeros(n_agents),
        silent=np.full(n_agents, silent),
        sensitivity=sensitivity,
        **kw,
    )


@dataclasses.dataclass
class EnvState:
    """Dynamic state of a batch of B environments (entities: agents first,
    then landmarks)."""

    pos: torch.Tensor  # [B, n_entities, dim_p]
    vel: torch.Tensor  # [B, n_entities, dim_p]
    c: torch.Tensor  # [B, n_agents, dim_c] communication utterances
    ideal_shape: torch.Tensor  # [B, n_landmarks, dim_p]
    ideal_vel: torch.Tensor  # [B, dim_p]
    t: torch.Tensor  # [B] int32: steps since episode start

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class StepOut:
    """Result of one batched env step."""

    obs: Optional[torch.Tensor]  # [B, n_agents, obs_dim]; None on the state-only step
    reward: torch.Tensor  # [B, n_agents] (shared-reward broadcast applied)
    done: torch.Tensor  # [B, n_agents] bool
    info: Dict[str, torch.Tensor]  # includes 'individual_reward' [B, n_agents]


_STATE_FIELDS = ("pos", "vel", "c", "ideal_shape", "ideal_vel", "t")


def state_from_numpy(
    arrays, device=None, dtype: torch.dtype = torch.float32
) -> EnvState:
    """Build an :class:`EnvState` from numpy arrays with a leading batch axis.

    ``arrays`` is any object with the state's fields as attributes or keys —
    a batched JAX ``EnvState`` (its ``key`` is ignored) or a dict.  Float
    fields are cast to ``dtype``; ``t`` becomes int32.
    """
    get = arrays.get if isinstance(arrays, dict) else lambda k: getattr(arrays, k)
    out = {}
    for name in _STATE_FIELDS:
        a = np.array(get(name))  # a writable copy
        dt = torch.int32 if name == "t" else dtype
        out[name] = torch.as_tensor(a).to(device=device, dtype=dt)
    return EnvState(**out)


def state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    """The state's fields as numpy arrays (batch axis first)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in _STATE_FIELDS}
