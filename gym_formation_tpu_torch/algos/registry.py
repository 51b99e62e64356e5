"""The learners by name: one factory for ``train`` and the eval policies of
``eval``.

Counterpart of ``gym_formation_tpu/algos/registry.py``.  The name tuples are
the JAX package's 13 ``--algo`` names; the port builds the on-policy family
(``mappo``, ``rmappo``) and the feed-forward off-policy one (``maddpg``,
``ddpg``, ``matd3``, ``masac``, ``qmix``, ``vdn``); the recurrent off-policy
names raise ``NotImplementedError``.
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
#: feed-forward off-policy: training tuple (ts, buffer, env_state, obs)
OFFPOLICY = ("maddpg", "ddpg", "matd3", "masac", "qmix", "vdn")


def _require_ported(name: str) -> None:
    if name not in ALGO_NAMES:
        raise ValueError(f"unknown algorithm {name!r}; choose from {ALGO_NAMES}")
    if name in EPISODIC:
        raise NotImplementedError(f"{name} is not yet ported: the port has {', '.join(ONPOLICY + OFFPOLICY)}")


def make_algo(name: str, env, num_envs: int, sets: Sequence[str] = (),
              config_yaml: Optional[str] = None, lr: Optional[float] = None, device="cuda",
              config: Optional[Mapping] = None):
    """The learner ``name`` over ``env`` on ``device``: config defaults ←
    ``config`` (a checkpoint's) ← ``config_yaml`` ← ``lr`` ← what the name
    implies (``ddpg``: ``centralized=False``; ``qmix``/``vdn``: the mixer)
    ← the ``key=value`` strings of ``sets``.  ``lr`` sets both
    ``lr_actor`` and ``lr_critic`` of the MADDPG family."""
    from ..utils.config import load_config
    from .maddpg import MADDPG, MADDPGConfig
    from .mappo import MAPPO, MAPPOConfig
    from .masac import MASAC, MASACConfig
    from .matd3 import MATD3, MATD3Config
    from .qmix import QMix, QMixConfig
    from .rmappo import RMAPPO, RMAPPOConfig

    _require_ported(name)
    cls, cfg_cls, implied = {
        "mappo": (MAPPO, MAPPOConfig, []),
        "rmappo": (RMAPPO, RMAPPOConfig, []),
        "maddpg": (MADDPG, MADDPGConfig, ["centralized=True"]),
        "ddpg": (MADDPG, MADDPGConfig, ["centralized=False"]),
        "matd3": (MATD3, MATD3Config, []),
        "masac": (MASAC, MASACConfig, []),
        "qmix": (QMix, QMixConfig, ["mixer=qmix"]),
        "vdn": (QMix, QMixConfig, ["mixer=vdn"]),
    }[name]
    lr_keys = ("lr_actor", "lr_critic") if issubclass(cfg_cls, MADDPGConfig) else ("lr",)
    overrides = ([f"{k}={lr}" for k in lr_keys] if lr is not None else []) + implied + list(sets)
    return cls(env, load_config(cfg_cls, config_yaml, overrides, base=config), num_envs=num_envs, device=device)


def eval_policy(name: str, algo, ts, batch_size: int, clip_continuous: bool = True,
                stochastic: bool = False, seed: int = 0) -> Tuple[Callable, object]:
    """The eval policy of a training state ``ts`` of ``algo``.

    Returns ``(policy_fn, carry0)`` with ``policy_fn(obs, carry) ->
    (actions, carry)`` over a ``[batch_size, N, obs_dim]`` observation.
    Continuous actions are clipped to ±``high_action`` (1 where the config
    has none) unless ``clip_continuous`` is False.  maddpg, ddpg and matd3
    take the actors' actions, masac ``tanh(mean) · high_action`` (unclipped,
    already in range), qmix and vdn the greedy one-hots of the shared Q;
    discrete actors give the one-hot of their logits' argmax.  mappo takes
    the mode of its distribution, or with
    ``stochastic`` a sample, drawn from a generator seeded by ``seed``
    (the carry).  rmappo threads ``(hidden [batch, N, H], reset flags
    [batch])``: call with ``carry0`` at each episode start, whose set reset
    flags zero the GRU state on the first step.
    """
    _require_ported(name)
    dtype = algo.dtype
    high = getattr(algo.cfg, "high_action", 1.0)

    def finish(a):
        return a if algo.discrete or not clip_continuous else a.clamp(-high, high)

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
    if name in OFFPOLICY:
        # masac's tanh(mean) · high_action is in range already
        clip = name != "masac"

        def feedforward(obs, carry=None):
            a = algo.eval_actions(ts, obs)
            return (finish(a) if clip else a), carry

        return feedforward, None
    carry0 = (torch.zeros(batch_size, algo.n_agents, algo.cfg.gru_hidden, dtype=dtype, device=algo.device),
              torch.ones(batch_size, dtype=torch.bool, device=algo.device))

    @torch.no_grad()
    def recurrent(obs, carry):
        h, reset = carry
        h, dist = ts.actor(h, obs.to(dtype), reset[:, None].expand(obs.shape[:2]))
        return finish(algo._dist_mode(dist)), (h, torch.zeros_like(reset))

    return recurrent, carry0
