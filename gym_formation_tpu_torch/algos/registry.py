"""The learners by name: one factory for ``train`` and the eval policies of
``eval``.

Counterpart of ``gym_formation_tpu/algos/registry.py``.  The name tuples are
the JAX package's 13 ``--algo`` names; the port builds the on-policy family
(``mappo``, ``rmappo``), and the other names raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch

#: every name of the JAX package's ``train.py --algo``
ALGO_NAMES = (
    "mappo", "rmappo", "maddpg", "ddpg", "matd3", "masac",
    "qmix", "vdn", "rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn",
)
#: algorithms whose env actions are 5-way one-hots by construction
DISCRETE_ONLY = ("qmix", "vdn", "rqmix", "rvdn")
#: recurrent (GRU) families: eval threads a hidden carry
RECURRENT = ("rmappo", "rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn")
#: on-policy family: training tuple (ts, env_state, obs[, carry])
ONPOLICY = ("mappo", "rmappo")
#: episodic recurrent off-policy: training tuple (ts, buffer)
EPISODIC = ("rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn")


def _require_ported(name: str) -> None:
    if name not in ALGO_NAMES:
        raise ValueError(f"unknown algorithm {name!r}; choose from {ALGO_NAMES}")
    if name not in ONPOLICY:
        raise NotImplementedError(f"{name} is not yet ported: the port has {', '.join(ONPOLICY)}")


def make_algo(name: str, env, num_envs: int, sets: Sequence[str] = (),
              config_yaml: Optional[str] = None, lr: Optional[float] = None, device="cuda",
              config: Optional[Mapping] = None):
    """The learner ``name`` over ``env`` on ``device``: config defaults ←
    ``config`` (a checkpoint's) ← ``config_yaml`` ← ``lr`` ← the
    ``key=value`` strings of ``sets``."""
    from ..utils.config import load_config
    from .mappo import MAPPO, MAPPOConfig
    from .rmappo import RMAPPO, RMAPPOConfig

    _require_ported(name)
    cls, cfg_cls = (MAPPO, MAPPOConfig) if name == "mappo" else (RMAPPO, RMAPPOConfig)
    overrides = ([f"lr={lr}"] if lr is not None else []) + list(sets)
    return cls(env, load_config(cfg_cls, config_yaml, overrides, base=config), num_envs=num_envs, device=device)


def eval_policy(name: str, algo, ts, batch_size: int, clip_continuous: bool = True,
                stochastic: bool = False, seed: int = 0) -> Tuple[Callable, object]:
    """The eval policy of a training state ``ts`` of ``algo``.

    Returns ``(policy_fn, carry0)`` with ``policy_fn(obs, carry) ->
    (actions, carry)`` over a ``[batch_size, N, obs_dim]`` observation.
    Continuous actions are clipped to ±1 unless ``clip_continuous`` is
    False.  mappo takes the mode of its distribution, or with
    ``stochastic`` a sample, drawn from a generator seeded by ``seed``
    (the carry).  rmappo threads ``(hidden [batch, N, H], reset flags
    [batch])``: call with ``carry0`` at each episode start, whose set reset
    flags zero the GRU state on the first step.
    """
    _require_ported(name)
    dtype = algo.dtype

    def finish(a):
        return a if algo.discrete or not clip_continuous else a.clamp(-1.0, 1.0)

    if name == "mappo":
        if stochastic:
            generator = torch.Generator(device=algo.device)
            generator.manual_seed(seed)

            @torch.no_grad()
            def sample(obs, carry):
                return finish(algo._dist_sample(carry, ts.actor(obs.to(dtype)))), carry

            return sample, generator

        @torch.no_grad()
        def mode(obs, carry=None):
            return finish(algo._dist_mode(ts.actor(obs.to(dtype)))), carry

        return mode, None
    if stochastic:
        raise SystemExit("--stochastic eval is implemented for mappo only")
    carry0 = (torch.zeros(batch_size, algo.n_agents, algo.cfg.gru_hidden, dtype=dtype, device=algo.device),
              torch.ones(batch_size, dtype=torch.bool, device=algo.device))

    @torch.no_grad()
    def recurrent(obs, carry):
        h, reset = carry
        h, dist = ts.actor(h, obs.to(dtype), reset[:, None].expand(obs.shape[:2]))
        return finish(algo._dist_mode(dist)), (h, torch.zeros_like(reset))

    return recurrent, carry0
