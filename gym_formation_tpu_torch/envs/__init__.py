"""Scenario registry: the five scenarios of the JAX package."""

from __future__ import annotations

from typing import Callable, Dict

from .scenario import Scenario
from .basic_formation import BasicFormationScenario
from .formation_hd import DEFAULT_LAYER_SHAPES, FormationHDScenario, generate_shape
from .formation_hd_obs import FormationHDObsScenario
from .formation_hd_partial import FormationHDPartialRangeScenario, FormationHDPartialScenario

SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "basic_formation_env": BasicFormationScenario,
    "formation_hd_env": FormationHDScenario,
    "formation_hd_obs_env": FormationHDObsScenario,
    "formation_hd_partial_env": FormationHDPartialScenario,
    "formation_hd_partial_range_env": FormationHDPartialRangeScenario,
}


def register(name: str, factory: Callable[..., Scenario]) -> None:
    """Register a custom scenario factory under ``name``."""
    SCENARIOS[name] = factory


def make_scenario(name: str, **kwargs) -> Scenario:
    """Instantiate a scenario by name, with scenario kwargs (num_agents,
    episode_length, …)."""
    if name in SCENARIOS:
        return SCENARIOS[name](**kwargs)
    raise ValueError(f"Unknown scenario {name!r}; available: {sorted(SCENARIOS)}")


__all__ = [
    "Scenario",
    "SCENARIOS",
    "register",
    "make_scenario",
    "generate_shape",
    "DEFAULT_LAYER_SHAPES",
    "BasicFormationScenario",
    "FormationHDScenario",
    "FormationHDObsScenario",
    "FormationHDPartialScenario",
    "FormationHDPartialRangeScenario",
]
