"""Learners of the port: the on-policy family (MAPPO, RMAPPO) and the
registry by name.  The rest of the JAX package's zoo is listed in ROADMAP."""

from .mappo import MAPPO, MAPPOConfig, MAPPOState, ValueNorm
from .registry import ALGO_NAMES, DISCRETE_ONLY, EPISODIC, ONPOLICY, RECURRENT, eval_policy, make_algo
from .rmappo import RMAPPO, RMAPPOConfig, RunnerCarry

__all__ = ["ALGO_NAMES", "DISCRETE_ONLY", "EPISODIC", "MAPPO", "MAPPOConfig", "MAPPOState", "ONPOLICY",
           "RECURRENT", "RMAPPO", "RMAPPOConfig", "RunnerCarry", "ValueNorm", "eval_policy", "make_algo"]
