"""The learners by name: one factory for ``train`` and the eval policies of
``eval``.

Counterpart of ``gym_formation_tpu/algos/registry.py``: the JAX package's
13 ``--algo`` names, the on-policy family (``mappo``, ``rmappo``), the
feed-forward off-policy zoo (``maddpg``, ``ddpg``, ``matd3``, ``masac``,
``qmix``, ``vdn``) and the recurrent one (``rmaddpg``, ``rmatd3``,
``rmasac``, ``rqmix``, ``rvdn``).
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


def _require_known(name: str) -> None:
    if name not in ALGO_NAMES:
        raise ValueError(f"unknown algorithm {name!r}; choose from {ALGO_NAMES}")


def make_algo(name: str, env, num_envs: int, sets: Sequence[str] = (),
              config_yaml: Optional[str] = None, lr: Optional[float] = None, device="cuda",
              config: Optional[Mapping] = None, mesh=None):
    """The learner ``name`` over ``env`` on ``device``: config defaults ←
    ``config`` (a checkpoint's) ← ``config_yaml`` ← ``lr`` ← what the name
    implies (``ddpg``: ``centralized=False``; ``rmatd3``: ``twin=True``;
    ``qmix``/``vdn``/``rqmix``/``rvdn``: the mixer) ← the ``key=value``
    strings of ``sets``.  ``lr`` sets both ``lr_actor`` and ``lr_critic``
    of the MADDPG family and of RMADDPG/RMATD3.

    ``mesh``: a data-parallel mesh (:mod:`gym_formation_tpu_torch.parallel`)
    that the env and the learner then carry; ``num_envs`` is the global
    batch and must divide by its size."""
    from ..parallel.mesh import per_rank
    from ..utils.config import load_config
    from .maddpg import MADDPG, MADDPGConfig
    from .mappo import MAPPO, MAPPOConfig
    from .masac import MASAC, MASACConfig
    from .matd3 import MATD3, MATD3Config
    from .qmix import QMix, QMixConfig
    from .rmaddpg import RMADDPG, RMADDPGConfig
    from .rmappo import RMAPPO, RMAPPOConfig
    from .rmasac import RMASAC, RMASACConfig
    from .rqmix import RQMix, RQMixConfig

    _require_known(name)
    if mesh is not None:
        env.mesh = mesh
    per_rank(num_envs, env.mesh)
    cls, cfg_cls, implied = {
        "mappo": (MAPPO, MAPPOConfig, []),
        "rmappo": (RMAPPO, RMAPPOConfig, []),
        "maddpg": (MADDPG, MADDPGConfig, ["centralized=True"]),
        "ddpg": (MADDPG, MADDPGConfig, ["centralized=False"]),
        "matd3": (MATD3, MATD3Config, []),
        "masac": (MASAC, MASACConfig, []),
        "qmix": (QMix, QMixConfig, ["mixer=qmix"]),
        "vdn": (QMix, QMixConfig, ["mixer=vdn"]),
        "rmaddpg": (RMADDPG, RMADDPGConfig, ["twin=False"]),
        "rmatd3": (RMADDPG, RMADDPGConfig, ["twin=True"]),
        "rmasac": (RMASAC, RMASACConfig, []),
        "rqmix": (RQMix, RQMixConfig, ["mixer=qmix"]),
        "rvdn": (RQMix, RQMixConfig, ["mixer=vdn"]),
    }[name]
    lr_keys = ("lr_actor", "lr_critic") if issubclass(cfg_cls, (MADDPGConfig, RMADDPGConfig)) else ("lr",)
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
    (the carry).  The recurrent names thread ``(hidden [batch, N, H], reset
    flags [batch])``: call with ``carry0`` at each episode start, whose set
    reset flags zero the GRU state on the first step.  rmappo takes its
    mode, rmaddpg and rmatd3 ``tanh(mean) · high_action``, rmasac the same
    of its mean head (both unclipped, in range already), rqmix and rvdn the
    greedy one-hots of the shared Q.
    """
    _require_known(name)
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

    if name == "rmappo":
        def step(h, obs, reset):
            h, dist = ts.actor(h, obs, reset[:, None].expand(obs.shape[:2]))
            return h, finish(algo._dist_mode(dist))
    elif name in ("rmaddpg", "rmatd3"):
        def step(h, obs, reset):
            return algo._actor_step(ts.actor, h, obs, reset)
    elif name == "rmasac":
        def step(h, obs, reset):
            h, (mean, _) = algo._actor_step(ts.actor, h, obs, reset)
            return h, torch.tanh(mean) * high
    else:
        def step(h, obs, reset):
            h, q = algo._q_step(ts.q, h, obs, reset)
            return h, torch.nn.functional.one_hot(q.argmax(-1), algo.N_ACTIONS).to(dtype)

    @torch.no_grad()
    def recurrent(obs, carry):
        h, reset = carry
        h, a = step(h, obs.to(dtype), reset)
        return a, (h, torch.zeros_like(reset))

    return recurrent, carry0
