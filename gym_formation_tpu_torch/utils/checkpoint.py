"""Checkpoints of the whole training tuple with ``torch.save``.

Counterpart of ``gym_formation_tpu/utils/checkpoint.py`` (orbax there).  A
checkpoint is one file, ``<dir>/<step>.pt``, holding whatever tree the learner
gives (for MAPPO, :meth:`~gym_formation_tpu_torch.algos.MAPPO.checkpoint_tree`:
networks, Adam moments and count, value norm, iteration, env state,
observations and the states of the generators), so a restored run continues
where it stopped.  Orbax checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(path) if (m := _NAME.match(f)))


def latest_step(path: str) -> Optional[int]:
    steps = _steps(path)
    return steps[-1] if steps else None


def save_checkpoint(path: str, step: int, tree: Any, max_to_keep: int = 5) -> str:
    """Write ``tree`` as ``<path>/<step>.pt`` (atomically) and keep only the
    newest ``max_to_keep`` checkpoints."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"{step}.pt")
    tmp = out + f".{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, out)
    for old in _steps(path)[:-max_to_keep]:
        os.remove(os.path.join(path, f"{old}.pt"))
    return out


def restore_checkpoint(path: str, step: Optional[int] = None) -> Any:
    """The tree of the given (or the latest) step, its tensors on the CPU."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    return torch.load(os.path.join(path, f"{step}.pt"), map_location="cpu", weights_only=False)
