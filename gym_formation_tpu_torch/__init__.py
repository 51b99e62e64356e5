"""gym_formation_tpu_torch — the formation-control environments in PyTorch.

The port of :mod:`gym_formation_tpu` (JAX) to PyTorch and CUDA for an NVIDIA
H100.  Functions work on batched tensors with an explicit leading env axis;
random draws come from an explicit ``torch.Generator``.  Every kernel the
JAX package wrote in Pallas for the TPU becomes a hand-written CUDA kernel
(``csrc/``, built at first use by :mod:`.ops._build`); on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.

Ported so far: the ``formation_hd_env`` step path under the scripted
hierarchical controller, with the pair-force (K1) and reward-statistics (K2)
kernels.  Importing this package makes no CUDA call and never imports JAX.
"""

from . import spaces
from .core import EnvState, StepOut, WorldCfg, state_from_numpy, state_to_numpy
from .env import (
    FormationEnv,
    VecFormationEnv,
    rollout,
    rollout_statepolicy,
    rollout_statepolicy_rewardsum,
)
from .envs import SCENARIOS, generate_shape, make_scenario, register
from .models import bfs_actions, bfs_actions_from_state, ezpolicy, ezpolicy_batched

__version__ = "0.1.0"


def make_env(
    scenario_name: str = "basic_formation_env",
    benchmark: bool = False,
    num_agents: int = 3,
    auto_reset: bool = True,
    discrete_action: bool = False,
    discrete_action_input: bool = False,
    force_discrete_action: bool = False,
    **scenario_kwargs,
) -> FormationEnv:
    """Build a batched env by scenario name (the JAX package's signature)."""
    scenario = make_scenario(scenario_name, num_agents=num_agents, **scenario_kwargs)
    return FormationEnv(
        scenario,
        benchmark=benchmark,
        auto_reset=auto_reset,
        discrete_action=discrete_action,
        discrete_action_input=discrete_action_input,
        force_discrete_action=force_discrete_action,
    )


def make_vec_env(
    scenario_name: str = "formation_hd_env",
    num_envs: int = 4096,
    benchmark: bool = False,
    num_agents: int = 3,
    device="cpu",
    seed: int = 0,
    **scenario_kwargs,
) -> VecFormationEnv:
    """Build ``num_envs`` envs on ``device`` with a generator seeded by
    ``seed`` (the JAX package's ``sharding`` argument becomes ``device``)."""
    env = make_env(
        scenario_name, benchmark=benchmark, num_agents=num_agents, **scenario_kwargs
    )
    return VecFormationEnv(env, num_envs, device=device, seed=seed)


__all__ = [
    "EnvState",
    "StepOut",
    "WorldCfg",
    "FormationEnv",
    "VecFormationEnv",
    "SCENARIOS",
    "spaces",
    "make_env",
    "make_vec_env",
    "make_scenario",
    "register",
    "rollout",
    "rollout_statepolicy",
    "rollout_statepolicy_rewardsum",
    "generate_shape",
    "ezpolicy",
    "ezpolicy_batched",
    "bfs_actions",
    "bfs_actions_from_state",
    "state_from_numpy",
    "state_to_numpy",
]
