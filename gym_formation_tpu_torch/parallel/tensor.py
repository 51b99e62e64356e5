"""Tensor parallelism: the ``'model'`` axis of the mesh.

Counterpart of ``gym_formation_tpu/parallel/mesh.py: model_sharding_for_params``
and of what XLA does with it.  The rule is JAX's, read on the flax layout of
each leaf (the converters' ``to_flax`` names): a leaf of two or more axes
whose last axis divides by TP is cut along that axis, every other leaf is
replicated.  Each layer declares where that rule falls in its own layout,
``tp_cuts``: parameter name → ``(dim, gates)``, the leaf cut along ``dim``,
each of its ``gates`` equal blocks into TP slices (:class:`Cut`), where a
block divides by TP.  In the port's layouts that is:

- ``nn.Linear.weight`` [out, in] (flax's [in, out]): rows, when out divides;
  its bias [out] stays whole;
- a stacked kernel [N, in, out], its bias [N, out] and a stacked
  ``log_std`` [N, act]: the last axis;
- a GRU weight [3H, in] (or [N, 3H, in]): flax keeps one kernel a gate
  ([in, H]), so each gate's H is cut, and rank r holds rows ``g·H +
  [r·H/TP, (r+1)·H/TP)`` of gates g = 0, 1, 2: a strided cut (``gates=3``);
  a stacked cell's biases alike, an unstacked cell's (1-D) stay whole.

Every rank holds its slice of each cut leaf, and of the leaf's Adam moments
(a learner's state names the parameters each of its Adam states follows,
``adam_params()``).  A cut layer computes the rank's output columns from its
slice and gathers them along the features at once (:func:`from_tp`, the
gradient's slice backward); its input enters through :func:`to_tp`
(identity forward, the input gradient summed over ``'model'`` backward).
So everything downstream of a layer is whole and equal on every rank of a
model group: the replicated leaves' gradients need no collective, and the
metrics are whole.  The global gradient norm sums the cut gradients'
squares over ``'model'`` (:func:`model_sum`, in ``ClipAdam``).  Kernels that
take whole weights (K5, K9) get them gathered (:func:`whole_module`) and
K9's gradients are cut back (:func:`local_like`).  Every call is counted
(and timed) in :data:`.mesh.stats` as ``model_all_gather`` /
``model_all_reduce``.

Without a mesh, or on a mesh without a model axis, nothing is cut and every
helper returns its input, so a layer has one forward for both.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from .mesh import _timed

AXIS = "model"


def size(mesh) -> int:
    """Ranks on the model axis (1 without a mesh or without that axis)."""
    if mesh is None or AXIS not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(AXIS))


def rank(mesh) -> int:
    """This rank's index on the model axis (0 without one)."""
    return 0 if size(mesh) == 1 else mesh.get_local_rank(AXIS)


def _group(mesh):
    return mesh.get_group(AXIS)


# -- the collectives --------------------------------------------------------------

def _all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    _timed("model_all_reduce", t, lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_group(mesh)))
    return t


def _all_gather(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every model rank's ``t``, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size(mesh))]
    _timed("model_all_gather", t, lambda: dist.all_gather(parts, t, group=_group(mesh)))
    return parts


def model_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the model axis (a new tensor; no autograd)."""
    return _all_reduce_(t.detach().clone(), mesh)


class _ToTP(torch.autograd.Function):
    """The input of a cut product: identity forward; the input gradient,
    each rank's share from its slice of the weight, summed backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.mesh), None


class _FromTP(torch.autograd.Function):
    """The output of a cut product: the ranks' columns gathered along the
    last axis forward; the rank's columns of the gradient backward (every
    rank holds the same whole gradient, so no reduction)."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.width = mesh, y.shape[-1]
        return torch.cat(_all_gather(y, mesh), -1)

    @staticmethod
    def backward(ctx, g):
        r, w = rank(ctx.mesh), ctx.width
        return g[..., r * w:(r + 1) * w].contiguous(), None


def to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` entering a product whose weight is cut over the model axis."""
    return x if size(mesh) == 1 else _ToTP.apply(x, mesh)


def from_tp(y: torch.Tensor, mesh, gates: int = 1) -> torch.Tensor:
    """The ranks' output columns ``y`` [..., gates·w] gathered into the
    whole [..., gates·TP·w]; with ``gates`` > 1 each rank's columns hold
    its slice of every gate (the strided cut), reordered gate by gate."""
    if size(mesh) == 1:
        return y
    out = _FromTP.apply(y, mesh)
    if gates == 1:
        return out
    w = y.shape[-1] // gates
    lead = out.shape[:-1]
    return out.reshape(*lead, size(mesh), gates, w).transpose(-3, -2).reshape(*lead, -1)


# -- the layout ---------------------------------------------------------------------

class Cut(NamedTuple):
    """A parameter's cut over the model axis: along ``dim``, each of its
    ``gates`` equal blocks cut into TP slices."""

    mesh: object
    dim: int
    gates: int

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``t`` (a copy)."""
        tp, r = size(self.mesh), rank(self.mesh)
        blocks = t.unflatten(self.dim, (self.gates, t.shape[self.dim] // self.gates))
        w = blocks.shape[self.dim + 1] // tp
        return blocks.narrow(self.dim + 1, r * w, w).flatten(self.dim, self.dim + 1).clone()

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of the ranks' slices ``t`` (a collective; no
        autograd)."""
        d, g = self.dim, self.gates
        parts = [p.unflatten(d, (g, p.shape[d] // g)) for p in _all_gather(t.detach(), self.mesh)]
        return torch.stack(parts, d + 1).flatten(d, d + 2)


def cut_of(p: torch.Tensor) -> Optional[Cut]:
    """The cut of a parameter :func:`shard_module_` cut, else None."""
    return getattr(p, "tp_cut", None)


def model_axis(p: torch.Tensor):
    """The mesh over whose model axis ``p`` is cut, else None."""
    cut = cut_of(p)
    return None if cut is None else cut.mesh


def layout(module: torch.nn.Module, name: str, p: torch.Tensor, tp: int):
    """``(dim, gates)`` of the cut ``module`` declares for its parameter
    ``name`` (``tp_cuts``) where each gate's block divides by ``tp``, else
    None: the parameter is replicated."""
    cut = getattr(module, "tp_cuts", {}).get(name)
    if cut is None or (p.shape[cut[0]] // cut[1]) % tp:
        return None
    return cut


def shard_module_(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Cut, in place, every parameter of ``module`` that the rule shards to
    this rank's slice, and mark it with its :class:`Cut`."""
    tp = size(mesh)
    if tp == 1:
        return module
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            where = layout(m, name, p, tp)
            if where is not None and cut_of(p) is None:
                cut = Cut(mesh, *where)
                p.data = cut.local(p.data)
                p.tp_cut = cut
    return module


def whole_module(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` itself when nothing of it is cut, else a copy holding
    every parameter whole (gathered; no autograd)."""
    params = list(module.parameters())
    if all(cut_of(p) is None for p in params):
        return module
    out = copy.deepcopy(module)
    for p, q in zip(params, out.parameters()):
        if cut_of(p) is not None:
            q.data = cut_of(p).whole(p.data)
    return out


def gathered(p: torch.Tensor) -> torch.Tensor:
    """A parameter used whole (a stacked ``log_std``): gathered along its
    cut axis, the last one, with the gradient's slice backward."""
    cut = cut_of(p)
    return p if cut is None else from_tp(p, cut.mesh)


def local_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The slice of a whole ``t`` (a gradient) that ``p``'s rank holds."""
    cut = cut_of(p)
    return t if cut is None else cut.local(t)


# -- a learner's state ---------------------------------------------------------------

def _modules(ts) -> Dict[str, torch.nn.Module]:
    return {f.name: getattr(ts, f.name) for f in dataclasses.fields(ts)
            if isinstance(getattr(ts, f.name), torch.nn.Module)}


def _map_moments(ts, fn) -> Dict:
    """Each Adam state of ``ts`` with ``fn(cut, moment)`` in place of every
    moment of a cut parameter."""
    out = {}
    for name, ps in ts.adam_params().items():
        st = getattr(ts, name)
        move = lambda ms: [m if cut_of(p) is None else fn(cut_of(p), m) for p, m in zip(ps, ms, strict=True)]
        out[name] = st._replace(mu=move(st.mu), nu=move(st.nu))
    return out


def shard_params_(ts, mesh):
    """Cut a learner's training state in place: every network's parameters
    (online and target) that the rule shards, and their Adam moments, to
    this rank's slices.  Returns ``ts``."""
    if size(mesh) == 1:
        return ts
    for m in _modules(ts).values():
        shard_module_(m, mesh)
    for name, st in _map_moments(ts, lambda cut, m: cut.local(m)).items():
        setattr(ts, name, st)
    return ts


def whole_state(ts, mesh):
    """A copy of a cut training state with every parameter and moment
    whole (a collective: every rank of the model group calls it); ``ts``
    itself without a model axis."""
    if size(mesh) == 1:
        return ts
    out = copy.copy(ts)
    for name, m in _modules(ts).items():
        setattr(out, name, whole_module(m))
    for name, st in _map_moments(ts, lambda cut, m: cut.whole(m)).items():
        setattr(out, name, st)
    return out


def held_bytes(ts) -> Dict[str, int]:
    """The bytes this rank holds of a training state's parameters (online
    and target networks) and Adam moments."""
    nets = sum(p.numel() * p.element_size() for m in _modules(ts).values() for p in m.parameters())
    moments = sum(t.numel() * t.element_size() for name in ts.adam_params()
                  for t in getattr(ts, name).mu + getattr(ts, name).nu)
    return {"params": nets, "moments": moments}
