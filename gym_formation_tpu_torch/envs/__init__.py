"""Scenario registry.

Only ``formation_hd_env`` is ported so far.  The other scenario names of the
JAX package raise ``ValueError`` naming them as not yet ported.
"""

from __future__ import annotations

from typing import Callable, Dict

from .scenario import Scenario
from .formation_hd import DEFAULT_LAYER_SHAPES, FormationHDScenario, generate_shape

SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "formation_hd_env": FormationHDScenario,
}

NOT_YET_PORTED = (
    "basic_formation_env",
    "formation_hd_obs_env",
    "formation_hd_partial_env",
    "formation_hd_partial_range_env",
)


def register(name: str, factory: Callable[..., Scenario]) -> None:
    """Register a custom scenario factory under ``name``."""
    SCENARIOS[name] = factory


def make_scenario(name: str, **kwargs) -> Scenario:
    """Instantiate a scenario by name, with scenario kwargs (num_agents,
    episode_length, …)."""
    if name in SCENARIOS:
        return SCENARIOS[name](**kwargs)
    if name in NOT_YET_PORTED:
        raise ValueError(
            f"Scenario {name!r} is not yet ported to gym_formation_tpu_torch; "
            f"available: {sorted(SCENARIOS)}"
        )
    raise ValueError(f"Unknown scenario {name!r}; available: {sorted(SCENARIOS)}")


__all__ = [
    "Scenario",
    "SCENARIOS",
    "NOT_YET_PORTED",
    "register",
    "make_scenario",
    "generate_shape",
    "DEFAULT_LAYER_SHAPES",
    "FormationHDScenario",
]
