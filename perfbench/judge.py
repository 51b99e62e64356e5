"""The numbers that decide ``correct``: the program's outputs against the
plain reference's.

Training, a cell that the reference follows whole (three iterations from
the benchmark's own weights and episodes): each iteration's mean step
reward and loss; Adam's first moment
after the first iteration (the gradients of its epochs as the optimizer
holds them), by the worst leaf; the parameters' change over the three
iterations, by the worst leaf.  A leaf's gap is the gap between the two
norms, over the reference's norm of that leaf or of the median leaf,
whichever is larger.  Leaves whose first moment in the reference is under
a thousandth of the median leaf's move by round-off alone and are left out
of the change.  A cell that the reference follows step by step from the
program's own state (``follow: steps``) compares each collection step
taken again from the program's state, the first optimizer step of each
iteration (its loss over the magnitude of the loss's terms, and its
gradient by the worst leaf), and the change over the first three
optimizer steps.

Rollout: every reward that the program reports within ``horizon`` steps of
a point where its trajectory and the reference's start from the same state
(a chunk's first step, the first step of an episode after an auto-reset),
and the chunk's mean reward over all of its steps and envs.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Optional[Iterable[str]] = None) -> float:
    keys = list(ref) if keep is None else [k for k in ref if k in set(keep)]
    nr = {k: _norm(ref[k]) for k in keys}
    med = sorted(nr.values())[len(nr) // 2]
    return max(abs(_norm(prog[k]) - nr[k]) / max(nr[k], med, 1e-300) for k in keys)


def moving_leaves(mu1_ref: Dict[str, torch.Tensor], floor: float = 1e-3) -> List[str]:
    nr = {k: _norm(v) for k, v in mu1_ref.items()}
    med = sorted(nr.values())[len(nr) // 2]
    return [k for k, v in nr.items() if v >= floor * med]


def total_loss(met: Dict[str, float], entropy_coef: float, value_coef: float) -> float:
    return met["pg_loss"] - entropy_coef * met["entropy"] + value_coef * met["v_loss"]


def loss_scale(met: Dict[str, float], entropy_coef: float, value_coef: float) -> float:
    """The sum of the loss's terms' magnitudes: a scale that does not vanish
    where the terms cancel."""
    return abs(met["pg_loss"]) + entropy_coef * abs(met["entropy"]) + value_coef * abs(met["v_loss"])


def rel_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref, strict=True))


def training_numbers(prog_losses, ref_losses, prog_mu1, ref_mu1, prog_change, ref_change) -> Dict[str, float]:
    moving = moving_leaves(ref_mu1)
    return dict(loss_gap=rel_gap(prog_losses, ref_losses), leaves_left_out=float(len(ref_mu1) - len(moving)),
                grad_gap=leaf_gap(prog_mu1, ref_mu1),
                change_gap=leaf_gap(prog_change, ref_change, moving))


def rollout_numbers(prog: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
                    prog_mean: Optional[float], ref_mean: Optional[float], rel: float) -> Dict[str, float]:
    """``prog``/``ref`` [T, B] rewards, ``mask`` [T, B] the entries that
    start from the same state within the horizon.  The share of those that
    differ by more than ``rel`` of the reference's magnitude, and (where
    given) the relative gap of a chunk's mean reward."""
    p, r = prog.double()[mask], ref.double()[mask]
    wrong = (p - r).abs() > rel * r.abs().clamp_min(1.0)
    out = dict(reward_mismatch_share=float(wrong.double().mean()) if p.numel() else math.nan,
               reward_gap_max=float(((p - r).abs() / r.abs().clamp_min(1.0)).max()) if p.numel() else math.nan,
               compared=float(p.numel()))
    if ref_mean is not None:
        out["chunk_mean_gap"] = abs(prog_mean - ref_mean) / max(abs(ref_mean), 1e-12)
    return out


def state_mismatch_share(pairs, tol: float = 1e-3) -> float:
    """The share of envs whose agents' positions or velocities differ by
    more than ``tol`` anywhere: ``pairs`` of (program positions,
    velocities, reference positions, velocities), each [b, N, 2]."""
    bad = total = 0
    for pp, pv, rp, rv in pairs:
        gap = torch.maximum((pp.double() - rp.double()).abs().amax((1, 2)),
                            (pv.double() - rv.double()).abs().amax((1, 2)))
        bad += int((gap > tol).sum())
        total += gap.numel()
    return bad / total if total else math.nan
