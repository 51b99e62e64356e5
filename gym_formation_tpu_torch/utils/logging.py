"""Metrics logging: ``<run_dir>/metrics.jsonl`` always, TensorBoard where
``tensorboardX`` imports, wandb when asked, and a matplotlib curve on demand.

Counterpart of ``gym_formation_tpu/utils/logging.py``: one JSON object a
logged iteration with ``step`` (env-steps so far), ``wall`` (seconds since the
logger opened) and every metric under the learner's own key.  A resumed run
appends to the same file, and the history already in it is read back, so
that :meth:`MetricsLogger.plot` draws the whole curve.  TensorBoard scalars
go to ``<run_dir>/tb``; wandb runs with ``use_wandb=True`` or the
environment's ``GFT_WANDB`` set (not ``0``).  Each optional sink is behind
its guard: a host without it (or, for wandb, without its service) logs the
JSON rows alone.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple


class MetricsLogger:
    def __init__(self, run_dir: str, use_tensorboard: bool = True, use_wandb: Optional[bool] = None,
                 wandb_kwargs: Optional[dict] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, "metrics.jsonl")
        self._history: Dict[str, List[Tuple[int, float]]] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        row = json.loads(line)
                    except json.JSONDecodeError:  # a line cut short by a killed run
                        continue
                    for k, v in row.items():
                        if k not in ("step", "wall"):
                            self._history.setdefault(k, []).append((row["step"], v))
        self._jsonl = open(path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except ImportError:
                pass
        self._wandb = None
        if use_wandb is None:
            use_wandb = os.environ.get("GFT_WANDB", "") not in ("", "0")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(dir=run_dir, **(wandb_kwargs or {"project": "gym-formation-tpu"}))
            except Exception as e:  # not installed, or no service to reach: the JSON rows carry on
                warnings.warn(f"wandb is off: {e!r}")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            row[k] = float(v)
            self._history.setdefault(k, []).append((int(step), row[k]))
            if self._tb is not None:
                self._tb.add_scalar(k, row[k], step)
        if self._wandb is not None:
            self._wandb.log({k: row[k] for k in metrics}, step=int(step))
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def plot(self, key: str = "mean_step_reward", fname: Optional[str] = None) -> None:
        """The curve of ``key`` over the env steps as a png (default
        ``<run_dir>/<key>.png``); nothing where matplotlib does not import
        or the key was never logged."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        if key not in self._history:
            return
        xs, ys = zip(*self._history[key])
        plt.figure(figsize=(6, 4))
        plt.plot(xs, ys)
        plt.xlabel("step")
        plt.ylabel(key)
        plt.tight_layout()
        plt.savefig(fname or os.path.join(self.run_dir, f"{key}.png"))
        plt.close()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
