"""Learners of the port: the on-policy family (MAPPO, RMAPPO), the
feed-forward off-policy zoo (MADDPG/DDPG with prioritized replay, MATD3,
MASAC, QMIX/VDN) and the registry by name.  The recurrent off-policy
learners are listed in ROADMAP."""

from .maddpg import MADDPG, MADDPGConfig, MADDPGState, OffPolicy, ReplayBuffer
from .mappo import MAPPO, MAPPOConfig, MAPPOState, ValueNorm
from .masac import MASAC, MASACConfig, MASACState
from .matd3 import MATD3, MATD3Config
from .per import PrioritizedReplayBuffer, beta_schedule
from .qmix import QMix, QMixConfig, QMixState
from .registry import (
    ALGO_NAMES, DISCRETE_ONLY, EPISODIC, OFFPOLICY, ONPOLICY, RECURRENT, eval_policy, make_algo,
)
from .rmappo import RMAPPO, RMAPPOConfig, RunnerCarry

__all__ = ["ALGO_NAMES", "DISCRETE_ONLY", "EPISODIC", "MADDPG", "MADDPGConfig", "MADDPGState", "MAPPO",
           "MAPPOConfig", "MAPPOState", "MASAC", "MASACConfig", "MASACState", "MATD3", "MATD3Config",
           "OFFPOLICY", "ONPOLICY", "OffPolicy", "PrioritizedReplayBuffer", "QMix", "QMixConfig", "QMixState",
           "RECURRENT", "RMAPPO", "RMAPPOConfig", "ReplayBuffer", "RunnerCarry", "ValueNorm", "beta_schedule",
           "eval_policy", "make_algo"]
