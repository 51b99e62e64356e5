"""The learners' optimizer, written out by hand.

Counterpart of ``optax.chain(optax.clip_by_global_norm(max_norm),
optax.adam(lr, eps=eps))`` as MAPPO and QMix build it
(``gym_formation_tpu/algos/mappo.py:251-254``, ``qmix.py:117``), and of the
plain ``optax.adam(lr)`` of MADDPG, MATD3 and MASAC (``max_norm=None``),
step for step:

- clip: every gradient is scaled by ``max_norm / ‖g‖`` when the global norm
  ``‖g‖`` over all of them is at least ``max_norm``.  This is not
  ``torch.nn.utils.clip_grad_norm_``, which divides by ``‖g‖ + 1e-6``.
  ``max_norm=None`` skips it.
- Adam: bias-corrected moments, ``eps`` outside the square root, and the
  update ``-lr · m̂ / (√v̂ + eps)`` added to the parameter.

The optimizer holds no parameters: :meth:`ClipAdam.step` takes the parameter
and gradient lists and the state ``(mu, nu, count)``, updates the
parameters in place and returns the new state.  Under tensor parallelism a
parameter cut over the model axis (:mod:`~..parallel.tensor`) comes with
its slice's gradient and moments; Adam acts elementwise on them, and the
clip's global norm sums the cut gradients' squares over the model axis.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..parallel import tensor as tp


class AdamState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int


class ClipAdam:
    def __init__(self, lr: float, max_norm: Optional[float] = None, eps: float = 1e-8, b1: float = 0.9,
                 b2: float = 0.999):
        self.lr, self.max_norm, self.eps, self.b1, self.b2 = lr, max_norm, eps, b1, b2

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params]
        return AdamState(mu=zeros(), nu=zeros(), count=0)

    def clip(self, grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
        """Global-norm clip.  The branch is taken on the device (no host
        read of the norm).  Where ``params`` has parameters cut over the
        model axis, their gradients' squares are summed over that axis by
        one ``all_reduce`` and each replicated gradient's counted once."""
        cuts = [tp.cut_of(p) for p in params]
        mesh = next((c.mesh for c in cuts if c is not None), None)
        if mesh is None:
            g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        else:
            whole = sum((g * g).sum() for g, c in zip(grads, cuts, strict=True) if c is None)
            cut = sum((g * g).sum() for g, c in zip(grads, cuts) if c is not None)
            g_norm = torch.sqrt(whole + tp.model_sum(cut, mesh))
        keep = g_norm < self.max_norm
        return [torch.where(keep, g, (g / g_norm.to(g.dtype)) * self.max_norm) for g in grads]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: AdamState) -> AdamState:
        if self.max_norm is not None:
            grads = self.clip(grads, params)
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * g ** 2 + b2 * v for g, v in zip(grads, state.nu)]
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        for p, m, v in zip(params, mu, nu):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.add_(u * (-self.lr))
        return AdamState(mu=mu, nu=nu, count=count)
