"""The data-parallel mesh and the helpers that place a training tuple on it.

Counterpart of ``gym_formation_tpu/parallel/mesh.py``.  The JAX package runs
one controller over a mesh of devices and lets XLA insert the collectives;
here every rank is one process holding one card (``torch.distributed``), the
mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks
with the axis ``'data'``, and the collectives are written out.

The contract of a run over W ranks with a global batch of B envs: it
computes what one process computes with the same B and the same seed, up to
the order of a collective's sums.

- Every rank draws its random numbers at the **global** shape from the same
  generator and keeps its rows (:func:`draw_rows`, :func:`local_rows`):
  rank r holds envs ``[r·B/W, (r+1)·B/W)``, and W ranks consume exactly the
  draws of one process.
- Sums over envs (losses, gradients, advantage statistics, the value norm,
  metrics) are each rank's share of the global sum, combined by one
  ``all_reduce(SUM)`` (:func:`all_reduce_`, :func:`sum_flat`).
- Replay buffers are replicated: each step's transitions are gathered
  (:func:`all_gather_rows`), so every rank holds the whole ring and samples
  and updates on identical data with identical draws.

Every helper takes ``mesh=None`` as the single process: it then returns its
input, so a learner without a mesh runs exactly as before.

Tensor parallelism (the ``'model'`` axis, ``--mesh DP,TP`` with TP > 1) is not
ported yet (ROADMAP.md, Queue 1): :func:`parse_mesh_arg` refuses it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS = "data"

#: the collective calls by kind; with ``timing`` on, each call's time too:
#: CUDA events on the current stream around a call on card tensors (read by
#: :func:`collective_ms`), the host's clock around one on CPU tensors
stats = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "timing": False, "events": [], "host_ms": 0.0}


def reset_stats(timing: bool = False) -> None:
    """Zero the collective counters; ``timing`` also times each call."""
    stats.update(all_reduce=0, all_gather=0, broadcast=0, timing=timing, events=[], host_ms=0.0)


def collective_ms() -> float:
    """The timed collectives' milliseconds since :func:`reset_stats`
    (waits for the card's stream to pass the last event)."""
    if stats["events"]:
        stats["events"][-1][1].synchronize()
    return stats["host_ms"] + sum(a.elapsed_time(b) for a, b in stats["events"])


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Tuple[str, ...] = (AXIS,),
              device_type: Optional[str] = None):
    """A :class:`DeviceMesh` over the ranks of the initialized process group
    (``torch.distributed.init_process_group``, or :func:`~.multihost.
    initialize_multihost`), named ``axis_names``.  ``shape`` defaults to
    all ranks on the first axis; ``device_type`` to ``cuda`` when the
    backend is ``nccl``, else ``cpu``.  A rank on a card has selected it
    (``torch.cuda.set_device``) before."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (initialize_multihost)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the world has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def parse_mesh_arg(spec: str, device_type: str = "cuda", devices: Optional[int] = None) -> Tuple[int, int]:
    """The mesh shape ``(DP, TP)`` of a CLI string ``"DP"`` or ``"DP,TP"``.

    ``devices``: the cards a ``cuda`` run may take (default: the visible
    ones).  Raises for a malformed spec, for more ranks than cards on
    ``cuda``, and for TP > 1, which is not ported yet."""
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        raise ValueError(f"--mesh expects DP or DP,TP; got {spec!r}") from None
    dp = parts[0]
    tp = parts[1] if len(parts) > 1 else 1
    if len(parts) > 2 or dp < 1 or tp < 1:
        raise ValueError(f"--mesh expects DP or DP,TP; got {spec!r}")
    if tp > 1:
        raise ValueError(f"--mesh {spec}: tensor parallelism (TP > 1) is not ported yet; the port shards the "
                         "data axis only (ROADMAP.md, Queue 1: the tensor-parallel slice)")
    if device_type == "cuda":
        avail = torch.cuda.device_count() if devices is None else devices
        if dp * tp > avail:
            raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, only {avail} available "
                             "(torch.cuda.device_count())")
    return dp, tp


def batch_sharding(mesh=None):
    """The placement of a leading env-batch axis split over the data axis."""
    from torch.distributed.tensor import Shard

    return Shard(0)


def replicated(mesh=None):
    """The placement of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return Replicate()


# -- the rank's place on the mesh ---------------------------------------------

def size(mesh) -> int:
    """Ranks on the data axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(AXIS))


def rank(mesh) -> int:
    """This rank's index on the data axis (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(AXIS)


def group(mesh):
    return mesh.get_group(AXIS)


def per_rank(global_batch: int, mesh) -> int:
    """The rows of ``global_batch`` a rank holds; raises unless it divides
    by the data-parallel size."""
    w = size(mesh)
    if global_batch % w:
        raise ValueError(f"--num-envs {global_batch} must divide by the data-parallel mesh size {w}")
    return global_batch // w


# -- trees ----------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    """``fn`` over every tensor of a tree of dataclasses, named tuples,
    tuples, lists and dicts; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def local_rows(tree, mesh):
    """The rank's rows of every tensor of ``tree`` along its leading (global
    batch) axis: rank r keeps ``[r·b, (r+1)·b)`` with b = rows / W.  0-dim
    tensors stay whole.  Without a mesh, ``tree`` itself."""
    if mesh is None:
        return tree
    r = rank(mesh)

    def rows(x):
        if x.dim() == 0:
            return x
        b = per_rank(x.shape[0], mesh)
        return x[r * b:(r + 1) * b]

    return tree_map(rows, tree)


def draw_rows(draw: Callable, shape: Sequence[int], mesh):
    """``draw(shape)`` for the rank's ``shape`` (leading axis: its rows),
    made at the global shape and sliced, so that every rank consumes the
    generator as the single process does."""
    if mesh is None:
        return draw(tuple(shape))
    return local_rows(draw((shape[0] * size(mesh),) + tuple(shape[1:])), mesh)


def shard_batch(tree, mesh):
    """The rank's rows of a tree of global env-batch tensors (the helper of
    the JAX package's name); 0-dim leaves stay whole."""
    return local_rows(tree, mesh)


# -- collectives ------------------------------------------------------------------

def _timed(kind: str, t: torch.Tensor, call: Callable):
    stats[kind] += 1
    if not stats["timing"]:
        return call()
    if t.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        stats["events"].append((start, end))
        return out
    t0 = time.perf_counter()
    out = call()
    stats["host_ms"] += (time.perf_counter() - t0) * 1e3
    return out


def all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the data axis, in place."""
    if mesh is not None:
        _timed("all_reduce", t, lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group(mesh)))
    return t


def sum_flat(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each tensor summed over the data axis, by one ``all_reduce`` of their
    flat concatenation (one bucket, one call)."""
    if mesh is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, mesh)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
    return out


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the leading axis, in rank order."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(mesh))]
    _timed("all_gather", x, lambda: dist.all_gather(parts, x, group=group(mesh)))
    return torch.cat(parts)


def gather_rows(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """:func:`all_gather_rows` of several tensors with the same leading
    axis, one call for each dtype among them (their rows flattened side by
    side)."""
    if mesh is None:
        return list(tensors)
    out = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        b = tensors[idx[0]].shape[0]
        flat = all_gather_rows(torch.cat([tensors[i].reshape(b, -1) for i in idx], 1), mesh)
        o = 0
        for i in idx:
            w = tensors[i][0].numel() if b else 0
            out[i] = flat[:, o:o + w].reshape((flat.shape[0],) + tuple(tensors[i].shape[1:]))
            o += w
    return out


def rank_mean(metrics, mesh):
    """Means over each rank's rows (every rank holds as many) → means over
    the global batch, by one ``all_reduce`` of the stacked values."""
    if mesh is None or not metrics:
        return metrics
    keys = list(metrics)
    (tot,) = sum_flat([torch.stack([torch.as_tensor(metrics[k]) for k in keys])], mesh)
    return dict(zip(keys, tot / size(mesh)))


def broadcast_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's ``t`` into every rank's, in place."""
    if mesh is None:
        return t
    g = group(mesh)
    src = dist.get_global_rank(g, 0)
    if t.is_contiguous():
        _timed("broadcast", t, lambda: dist.broadcast(t, src=src, group=g))
        return t
    buf = t.contiguous()
    _timed("broadcast", buf, lambda: dist.broadcast(buf, src=src, group=g))
    return t.copy_(buf)


#: fields of a learner's state that hold the rank's envs' rows (MADDPG's
#: Ornstein-Uhlenbeck noise), which a replication leaves alone
BATCH_FIELDS = ("ou_state",)


def replicate_(obj, mesh):
    """Rank 0's tensors into every rank's, in place, over a tree that may
    hold modules (parameters and buffers), replay buffers (their
    ``_tensors``) and mutable dataclasses (but not their
    :data:`BATCH_FIELDS`).  Returns ``obj``."""
    if mesh is None or obj is None:
        return obj
    if isinstance(obj, torch.Tensor):
        with torch.no_grad():
            return broadcast_(obj, mesh)
    if isinstance(obj, torch.nn.Module):
        for t in obj.state_dict(keep_vars=True).values():
            replicate_(t.data if isinstance(t, torch.nn.Parameter) else t, mesh)
        return obj
    if hasattr(obj, "_tensors") and hasattr(obj, "state_dict"):  # a replay buffer
        for k in obj._tensors:
            replicate_(getattr(obj, k), mesh)
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.name not in BATCH_FIELDS:
                replicate_(getattr(obj, f.name), mesh)
        return obj
    if isinstance(obj, dict):
        for v in obj.values():
            replicate_(v, mesh)
        return obj
    if isinstance(obj, (list, tuple)):
        for v in obj:
            replicate_(v, mesh)
    return obj


# -- the training tuple -------------------------------------------------------------

def _family(name: str) -> str:
    from ..algos.registry import EPISODIC, ONPOLICY, OFFPOLICY, _require_known

    _require_known(name)
    return "onpolicy" if name in ONPOLICY else "episodic" if name in EPISODIC else (
        "offpolicy" if name in OFFPOLICY else name)


def shard_train_tuple(name: str, state, mesh):
    """Place the global training tuple of the learner ``name`` (an
    unsharded ``init``, or a restored checkpoint) on ``mesh``: parameters,
    optimizer states and counters broadcast from rank 0; the env state,
    observations, recurrent carries and MADDPG's OU state cut to the rank's
    rows; replay buffers replicated whole.  For all 13 names:

    - on-policy ``(ts, env_state, obs[, carry])``;
    - feed-forward off-policy ``(ts, buffer, env_state, obs)``;
    - recurrent off-policy ``(ts, buffer)``.
    """
    family = _family(name)
    out = list(state)
    ts = replicate_(out[0], mesh)
    for f in BATCH_FIELDS:
        if getattr(ts, f, None) is not None:
            setattr(ts, f, local_rows(getattr(ts, f), mesh))
    first_batch = 1 if family == "onpolicy" else 2
    if family != "onpolicy":
        replicate_(out[1], mesh)
    for i in range(first_batch, len(out)):
        out[i] = local_rows(out[i], mesh)
    return out


def gather_train_tuple(name: str, state, mesh):
    """Inverse of :func:`shard_train_tuple`: the global tuple, every rank's
    rows gathered (a collective: every rank calls it), for a checkpoint that
    restores under any data-parallel size."""
    from .multihost import host_local_to_global

    if mesh is None:
        return list(state)
    family = _family(name)
    out = list(state)
    ts = out[0]
    for f in BATCH_FIELDS:
        if getattr(ts, f, None) is not None:
            ts = dataclasses.replace(ts, **{f: host_local_to_global(getattr(ts, f), mesh)})
    out[0] = ts
    first_batch = 1 if family == "onpolicy" else 2
    for i in range(first_batch, len(out)):
        out[i] = host_local_to_global(out[i], mesh)
    return out


