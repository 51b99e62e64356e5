"""Count fresh processes whose first call of a CPU function differs from its later calls.

    python tools/first_call_probe.py [--root DIR] [--procs 30] [--jobs 4]

Runs ``--procs`` fresh Python processes (``--jobs`` at a time, none of them
importing JAX) for each probe and prints, per probe, how many gave a first
call whose bits differ from the second call's:

- ``k8``: ``collision_forces_culled_plain`` of the ``gym_formation_tpu_torch``
  under DIR (default: this checkout) on the inputs of
  ``tests/test_torch_pairforce_cull.py``'s ``hd_case`` (B=5, E=486);
- ``k8_warm``: the same after one call each of ``torch.sqrt`` and
  ``torch.exp`` on 8 floats, which stay on one thread (below the intra-op
  grain size);
- ``exp``: ``torch.exp`` of 1,180,980 floats, split over the intra-op
  threads, with the number of differing elements and the largest relative
  difference of each process that differs.

On a build of PyTorch whose CPU kernels of ``exp``, ``sqrt`` and a few more
call MKL's vector math library, a difference in ``exp`` covers one thread's
contiguous share of the elements: the first call of a process, split over
the threads, can run one share in another routine.  CPU only; the numbers
depend on the host's thread count.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

K8 = """
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[1])
if sys.argv[2] == "warm":
    torch.sqrt(torch.ones(8)); torch.exp(torch.ones(8))
from gym_formation_tpu_torch.core import make_world_cfg
from gym_formation_tpu_torch.ops.kernels import pairforce_cull
cfg = make_world_cfg(243, 243, agent_size=0.03, landmark_size=0.01)
pos = torch.as_tensor(np.random.RandomState(0).uniform(-0.5, 0.5, (5, 486, 2)).astype(np.float32))
f = [pairforce_cull.collision_forces_culled_plain(pos, cfg) for _ in range(2)]
print(int((f[0] != f[1]).sum()), float((f[0] - f[1]).abs().max()))
"""

EXP = """
import numpy as np, torch
s = torch.as_tensor(np.random.RandomState(0).uniform(0.01, 1.0, (5 * 486 * 486,)).astype(np.float32))
a, b = torch.exp(-s), torch.exp(-s)
print(int((a != b).sum()), float(((a - b).abs() / b.abs()).max()))
"""


def run(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True, check=True)
    n, err = out.stdout.split()
    return int(n), float(err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--procs", type=int, default=30)
    ap.add_argument("--jobs", type=int, default=4)
    args = ap.parse_args()
    probes = {"k8": (K8, str(args.root), "cold"), "k8_warm": (K8, str(args.root), "warm"), "exp": (EXP,)}
    for name, call in probes.items():
        with ThreadPoolExecutor(args.jobs) as pool:
            res = list(pool.map(lambda _: run(*call), range(args.procs)))
        bad = [r for r in res if r[0]]
        print(json.dumps(dict(probe=name, root=str(args.root) if name != "exp" else None, procs=args.procs,
                              first_call_differs=len(bad), elements=[r[0] for r in bad],
                              max_diff=[r[1] for r in bad])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
