from .scripted import ezpolicy, ezpolicy_batched, parse_hd_obs
from .bfs import bfs_actions, bfs_actions_from_state, num_layers

__all__ = [
    "ezpolicy",
    "ezpolicy_batched",
    "parse_hd_obs",
    "bfs_actions",
    "bfs_actions_from_state",
    "num_layers",
]
