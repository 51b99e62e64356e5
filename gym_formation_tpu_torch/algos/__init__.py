"""Learners of the port.  Only MAPPO so far; the rest of the JAX package's
zoo is listed in ROADMAP."""

from .mappo import MAPPO, MAPPOConfig, MAPPOState, ValueNorm

__all__ = ["MAPPO", "MAPPOConfig", "MAPPOState", "ValueNorm"]
