"""Process-group set-up and the host-local ↔ global helpers.

Counterpart of ``gym_formation_tpu/parallel/multihost.py``.  The JAX package
federates processes with ``jax.distributed`` and assembles global arrays
from host-local shards; here every rank is one process (one card), the
world is a ``torch.distributed`` process group, and a global batch is the
concatenation of the ranks' rows in rank order.

Launch a world on one host with ``python -m gym_formation_tpu_torch.train
--mesh DP[,TP]`` (it spawns the ranks), or on several hosts under
``torchrun`` with ``--multihost``, which reads the rendezvous from
torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) as ``jax.distributed`` reads a pod's.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import AXIS, all_gather_rows, make_mesh, replicate_, tree_map


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None,
                         device_type: Optional[str] = None) -> None:
    """Join the process group: ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` as given, or from torchrun's
    environment where they are None.  ``backend``: ``nccl`` for a world of
    cards, ``gloo`` for the CPU (the default follows ``device_type``,
    ``cuda`` unless given); gloo on cards only when asked for.  A rank on a
    card selects its card (``LOCAL_RANK``, else the rank modulo the visible
    cards) before the group starts."""
    device_type = device_type or "cuda"
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend runs on cards: pass device_type='cuda' or backend='gloo'")
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: run the world on the CPU (backend gloo, device cpu)")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank)


def pod_mesh(tp: int = 1, device_type: Optional[str] = None):
    """The mesh over every rank of the world: data-parallel over ``world //
    tp``, tensor-parallel over ``tp``: ``('data', 'model')`` of shape
    ``(world // tp, tp)`` (rank ``d·tp + m`` at data index d, model index
    m), or the 1-D ``('data',)`` mesh for ``tp == 1``."""
    world = dist.get_world_size()
    if world % tp:
        raise ValueError(f"a model axis of {tp} does not divide the world of {world}")
    if tp == 1:
        return make_mesh((world,), device_type=device_type)
    return make_mesh((world // tp, tp), (AXIS, "model"), device_type=device_type)


def per_host_batch(global_batch: int) -> int:
    """The envs this process holds of ``global_batch`` (which must divide
    evenly across the processes)."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % p:
        raise ValueError(f"global batch {global_batch} does not divide across {p} processes")
    return global_batch // p


def host_local_to_global(tree, mesh):
    """The global batch of a tree of rank-local rows: every tensor's rows
    gathered from the ranks in rank order (a collective).  0-dim tensors
    must be equal on every rank, and are returned as they are."""

    def gather(x):
        if x.dim() > 0:
            return all_gather_rows(x, mesh)
        every = all_gather_rows(x.reshape(1), mesh)
        if not bool((every == every[0]).all()):
            raise ValueError(f"a 0-dim leaf differs across ranks: {every.tolist()}")
        return x

    if mesh is None:
        return tree
    return tree_map(gather, tree)


def replicate_global(tree, mesh):
    """Rank 0's tree on every rank (a broadcast of each tensor, in place;
    modules' parameters and buffers included).  Returns ``tree``."""
    return replicate_(tree, mesh)


def _rank_main(rank: int, fn, world: int, port: int, backend: str, device_type: str, args, tp: int) -> None:
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend, device_type)
    try:
        fn(pod_mesh(tp, device_type), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), backend: Optional[str] = None, device_type: str = "cuda", tp: int = 1) -> None:
    """Run ``fn(mesh, *args)`` in ``world`` new processes on this host, one
    rank each, joined by a rendezvous on a free localhost port (``fn`` a
    module-level function), on the mesh of :func:`pod_mesh` (``tp``).
    Returns when every rank has returned; if one raises, the others are
    stopped and this raises."""
    import torch.multiprocessing as mp

    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    with socket.socket() as s:  # a free port on localhost for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank_main, args=(fn, world, port, backend, device_type, tuple(args), tp), nprocs=world,
             join=True)
