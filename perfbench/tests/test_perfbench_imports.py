"""Nothing the benchmark loads is JAX or the JAX package, and the plain
reference reaches nothing of the program.  Each check runs in a fresh
interpreter, so that what this test process holds does not count."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

HARNESS = r"""
import json, sys
sys.path.insert(0, {root!r})
from perfbench import calibrate, faults, harness, judge, counts
from perfbench.drivers import common, rollout, train
import gym_formation_tpu_torch
bench = harness.benchmark()
for m in bench["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = r"""
import json, sys
sys.path.insert(0, {root!r})
from perfbench.reference import formation, mappo, prng
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_readers_load_no_jax():
    names = _top_names(HARNESS)
    assert "gym_formation_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "gym_formation_tpu"}


def test_reference_reaches_nothing_of_the_program():
    names = _top_names(REFERENCE)
    assert not names & {"gym_formation_tpu_torch", "gym_formation_tpu", "jax", "jaxlib", "flax"}
