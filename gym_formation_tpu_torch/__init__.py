"""gym_formation_tpu_torch — the formation-control environments in PyTorch.

The port of :mod:`gym_formation_tpu` (JAX) to PyTorch and CUDA for an NVIDIA
H100.  Functions work on batched tensors with an explicit leading env axis;
random draws come from an explicit ``torch.Generator``.  Every kernel the
JAX package wrote in Pallas for the TPU becomes a hand-written CUDA kernel
(``csrc/``, built at first use by :mod:`.ops._build`); on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.

Ported: the five scenarios of the JAX package; the step path under the
scripted hierarchical controller, with the pair-force kernels K1 (uniform
subsets), K6 (dense, any subset) and K8 (Morton-culled), chosen by
:func:`~.core.set_pallas_impl`, and the reward-statistics kernels K2 and K7,
chosen by :func:`~.core.set_reward_impl`; the fused rollout
:func:`rollout_statepolicy_fused` on the fused step kernel (K3, with the
BFS + ezpolicy expansion in-kernel); the whole-rollout kernel (K4,
``ops.kernels.fused_rollout``); and the MAPPO learner (:mod:`.algos`) with
its fused collection (K5) and fused PPO gradient (K9) kernels, the obs-free
structured first layers for N >= 32, and the ``python -m
gym_formation_tpu_torch.train`` entry point; the user-facing surface: the
list and dict wrappers (:class:`GymMultiAgentEnv`, :class:`DictAgentEnv`),
:func:`get_action_BFS`, the original environment's resets
(:mod:`.compat`), the renderer (:mod:`.render`), the keyboard policy
(:mod:`.policy`), profiling (:mod:`.utils.profiling`) and ``python -m
gym_formation_tpu_torch.demo``; data parallelism over ``torch.distributed``
(:mod:`.parallel`: ``train --mesh DP``, ``--multihost``,
:func:`rollout_statepolicy_fused_sharded`, ``python -m
gym_formation_tpu_torch.graft_entry`` with the flagship forward ``entry()``);
the headline benchmark ``python -m gym_formation_tpu_torch.bench``.

Entry points that place tensors (:func:`make_vec_env`,
:class:`VecFormationEnv`, the wrappers, :func:`get_action_BFS`,
:class:`~.algos.MAPPO`) run on the card unless given ``device="cpu"``, and
raise without one.  Importing this package
makes no CUDA call and never imports JAX.
"""

from . import spaces
from .core import EnvState, StepOut, WorldCfg, state_from_numpy, state_to_numpy
from .env import (
    FormationEnv,
    VecFormationEnv,
    rollout,
    rollout_stateonly,
    rollout_statepolicy,
    rollout_statepolicy_fused,
    rollout_statepolicy_fused_sharded,
    rollout_statepolicy_rewardsum,
)
from .envs import SCENARIOS, generate_shape, make_scenario, register
from .models import bfs_actions, bfs_actions_from_state, ezpolicy, ezpolicy_batched, get_action_BFS
from .wrappers import DictAgentEnv, GymMultiAgentEnv

__version__ = "0.1.0"


def make_env(
    scenario_name: str = "basic_formation_env",
    benchmark: bool = False,
    num_agents: int = 3,
    auto_reset: bool = True,
    discrete_action: bool = False,
    discrete_action_input: bool = False,
    force_discrete_action: bool = False,
    mesh=None,
    **scenario_kwargs,
) -> FormationEnv:
    """Build a batched env by scenario name (the JAX package's signature;
    ``mesh``: a data-parallel mesh, see :class:`FormationEnv`)."""
    scenario = make_scenario(scenario_name, num_agents=num_agents, **scenario_kwargs)
    return FormationEnv(
        scenario,
        benchmark=benchmark,
        auto_reset=auto_reset,
        discrete_action=discrete_action,
        discrete_action_input=discrete_action_input,
        force_discrete_action=force_discrete_action,
        mesh=mesh,
    )


def make_vec_env(
    scenario_name: str = "formation_hd_env",
    num_envs: int = 4096,
    benchmark: bool = False,
    num_agents: int = 3,
    device="cuda",
    seed: int = 0,
    **scenario_kwargs,
) -> VecFormationEnv:
    """Build ``num_envs`` envs on ``device`` with a generator seeded by
    ``seed`` (the JAX package's ``sharding`` argument becomes ``device``).
    The card is the default; without one this raises unless
    ``device="cpu"`` is given."""
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
    "GymMultiAgentEnv",
    "DictAgentEnv",
    "SCENARIOS",
    "spaces",
    "make_env",
    "make_vec_env",
    "make_scenario",
    "register",
    "rollout",
    "rollout_stateonly",
    "rollout_statepolicy",
    "rollout_statepolicy_rewardsum",
    "rollout_statepolicy_fused",
    "rollout_statepolicy_fused_sharded",
    "generate_shape",
    "ezpolicy",
    "ezpolicy_batched",
    "bfs_actions",
    "bfs_actions_from_state",
    "get_action_BFS",
    "state_from_numpy",
    "state_to_numpy",
]
