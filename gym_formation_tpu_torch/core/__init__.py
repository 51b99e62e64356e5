from .types import (
    EnvState,
    StepOut,
    WallCfg,
    WorldCfg,
    make_world_cfg,
    state_from_numpy,
    state_to_numpy,
)
from .physics import (
    action_forces,
    collision_forces,
    integrate,
    set_pallas_impl,
    set_reward_impl,
    wall_forces,
    world_step,
)

__all__ = [
    "EnvState",
    "StepOut",
    "WallCfg",
    "WorldCfg",
    "make_world_cfg",
    "state_from_numpy",
    "state_to_numpy",
    "action_forces",
    "collision_forces",
    "integrate",
    "set_pallas_impl",
    "set_reward_impl",
    "wall_forces",
    "world_step",
]
