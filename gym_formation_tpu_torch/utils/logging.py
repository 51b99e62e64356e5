"""Metrics logging to ``<run_dir>/metrics.jsonl``.

Counterpart of ``gym_formation_tpu/utils/logging.py``: one JSON object a
logged iteration with ``step`` (env-steps so far), ``wall`` (seconds since the
logger opened) and every metric under the learner's own key.  A resumed run
appends to the same file.  The JAX package's TensorBoard and wandb sinks are
not carried over.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
