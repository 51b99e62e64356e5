"""K3's time by phase on the card, by taking phases out of a copy of it.

    python tools/k3_phases.py [--out PATH]

Copies ``gym_formation_tpu_torch`` into ``build/k3_phases/<variant>/`` four
times, takes phases out of the copy's ``csrc/fused_step.cu``, and times
each copy's K3 at N=243, B=4096, ``stats="pre"`` on a fresh
``formation_hd_env`` batch, with the in-kernel BFS and with external
actions (20 launches each by CUDA events, one process per copy, the full
kernel first and last), and the host's enqueue time per launch beside it
(where the two meet, the copy is timed at the wrapper's host cost):

- ``full``: the kernel as it is;
- ``no_stats``: without the Hausdorff statistics (``haus_rect``);
- ``no_pairs``: without the pair sweep (forces and counts);
- ``neither``: without both: loads, the policy, integration, stores.

A phase's time is the full kernel's minus the copy's without it: the
phases overlap on the card, so the shares are estimates, not a partition.
The copies compute wrong results and serve only this timing.  Needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = "gym_formation_tpu_torch"
STATS = "  const float h = haus_rect(post ? qx : x, post ? qy : y, sx, sy, cx, cy, colmin, N, scratch);"
PAIRS_START = "  if (post)\n    pair_sweep(UniformPair<true, false>"
PAIRS_END = "N, own, react);\n\n"
VARIANTS = ("full", "no_stats", "no_pairs", "neither", "full")


def patch(src: str, variant: str) -> str:
    if variant in ("no_stats", "neither"):
        assert STATS in src
        src = src.replace(STATS, "  const float h = 0.f;")
    if variant in ("no_pairs", "neither"):
        i = src.index(PAIRS_START)
        j = src.index(PAIRS_END, i) + len(PAIRS_END)  # both branches: the blank line ends them
        src = src[:i] + src[j:]
    return src


def measure(root: Path) -> dict:
    import torch

    sys.path.insert(0, str(root))
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core import make_world_cfg
    from gym_formation_tpu_torch.ops.kernels import fused_step as k3

    assert Path(gt.__file__).resolve().is_relative_to(root.resolve()), gt.__file__
    dev = torch.device("cuda")
    B, N = 4096, 243
    st = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=N, device=dev, seed=0).reset_state()
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    act = torch.zeros(B, N, 2, device=dev)
    pos, vel = st.pos[:, :N], st.vel[:, :N]
    runs = {
        "bfs_ez": lambda: k3.fused_hd_step(pos, vel, None, st.ideal_shape, cfg, thresh=0.03, stats="pre",
                                           bfs_L=5, ideal_vel=st.ideal_vel, act_scale=5.0),
        "external": lambda: k3.fused_hd_step(pos, vel, act, st.ideal_shape, cfg, thresh=0.03, stats="pre"),
    }
    out = {}
    for name, fn in runs.items():
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(20):
            fn()
        end.record()
        out[name + "_host"] = (time.perf_counter() - t0) * 1e3 / 20  # enqueue
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 20
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", type=Path, default=None, help=argparse.SUPPRESS)  # one copy, in a child
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(measure(args.root)))
        return 0
    base = REPO / "build" / "k3_phases"
    src = (REPO / PKG / "csrc" / "fused_step.cu").read_text()
    rows, made = [], set()
    for variant in VARIANTS:
        root = base / variant
        if variant not in made:  # a fresh copy of the current source
            made.add(variant)
            shutil.rmtree(root, ignore_errors=True)
            shutil.copytree(REPO / PKG, root / PKG, ignore=shutil.ignore_patterns("__pycache__"))
            (root / PKG / "csrc" / "fused_step.cu").write_text(patch(src, variant))
        proc = subprocess.run([sys.executable, __file__, "--root", str(root)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rows.append(dict(variant=variant, **json.loads(proc.stdout.strip().splitlines()[-1])))
        print(json.dumps(rows[-1]), flush=True)
    full = {k: (rows[0][k] + rows[-1][k]) / 2 for k in ("bfs_ez", "external")}
    by = {r["variant"]: r for r in rows}
    for k in ("bfs_ez", "external"):
        print(f"K3 {k}: full {full[k]:.4f} ms; stats {full[k] - by['no_stats'][k]:.4f}, pair sweep "
              f"{full[k] - by['no_pairs'][k]:.4f}, the rest (loads, policy, integration) {by['neither'][k]:.4f} "
              f"(host enqueue {by['neither'][k + '_host']:.4f} ms a launch)")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
