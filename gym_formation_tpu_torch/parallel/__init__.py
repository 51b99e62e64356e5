"""Data parallelism over ``torch.distributed``: the counterpart of
``gym_formation_tpu/parallel/`` for its ``'data'`` axis (see
:mod:`.mesh`)."""

from .mesh import (
    batch_sharding,
    gather_train_tuple,
    local_rows,
    make_mesh,
    parse_mesh_arg,
    replicated,
    shard_batch,
    shard_train_tuple,
)
from .multihost import (
    host_local_to_global,
    initialize_multihost,
    per_host_batch,
    pod_mesh,
    replicate_global,
    spawn,
)

__all__ = [
    "batch_sharding",
    "gather_train_tuple",
    "local_rows",
    "make_mesh",
    "parse_mesh_arg",
    "replicated",
    "shard_batch",
    "shard_train_tuple",
    "host_local_to_global",
    "initialize_multihost",
    "per_host_batch",
    "pod_mesh",
    "replicate_global",
    "spawn",
]
