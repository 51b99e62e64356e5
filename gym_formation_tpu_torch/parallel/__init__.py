"""Data and tensor parallelism over ``torch.distributed``: the counterpart
of ``gym_formation_tpu/parallel/``, its ``'data'`` axis (:mod:`.mesh`) and
its ``'model'`` axis (:mod:`.tensor`)."""

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
from .tensor import shard_params_
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
    "shard_params_",
    "host_local_to_global",
    "initialize_multihost",
    "per_host_batch",
    "pod_mesh",
    "replicate_global",
    "spawn",
]
