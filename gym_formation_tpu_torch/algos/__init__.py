"""Learners of the port: the on-policy family (MAPPO, RMAPPO), the
feed-forward off-policy zoo (MADDPG/DDPG with prioritized replay, MATD3,
MASAC, QMIX/VDN), the recurrent off-policy zoo (RMADDPG/RMATD3, RMASAC,
RQMIX/RVDN over episode replay) and the registry by name."""

from .maddpg import MADDPG, MADDPGConfig, MADDPGState, OffPolicy, ReplayBuffer, ReplayLearner
from .mappo import MAPPO, MAPPOConfig, MAPPOState, ValueNorm
from .masac import MASAC, MASACConfig, MASACState
from .matd3 import MATD3, MATD3Config
from .per import PrioritizedReplayBuffer, beta_schedule
from .qmix import QMix, QMixConfig, QMixState
from .registry import (
    ALGO_NAMES, DISCRETE_ONLY, EPISODIC, OFFPOLICY, ONPOLICY, RECURRENT, eval_policy, make_algo,
)
from .rmaddpg import RMADDPG, EpisodeBuffer, Episodic, RMADDPGConfig, RMADDPGState
from .rmappo import RMAPPO, RMAPPOConfig, RunnerCarry
from .rmasac import RMASAC, RMASACConfig, RMASACState
from .rqmix import RQMix, RQMixConfig

__all__ = ["ALGO_NAMES", "DISCRETE_ONLY", "EPISODIC", "EpisodeBuffer", "Episodic", "MADDPG", "MADDPGConfig",
           "MADDPGState", "MAPPO", "MAPPOConfig", "MAPPOState", "MASAC", "MASACConfig", "MASACState", "MATD3",
           "MATD3Config", "OFFPOLICY", "ONPOLICY", "OffPolicy", "PrioritizedReplayBuffer", "QMix", "QMixConfig",
           "QMixState", "RECURRENT", "RMADDPG", "RMADDPGConfig", "RMADDPGState", "RMAPPO", "RMAPPOConfig",
           "RMASAC", "RMASACConfig", "RMASACState", "RQMix", "RQMixConfig", "ReplayBuffer", "ReplayLearner",
           "RunnerCarry", "ValueNorm", "beta_schedule", "eval_policy", "make_algo"]
