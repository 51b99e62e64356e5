"""Time the port's pair kernels K6 and K3 and count their pair loops' SASS.

    python tools/ab_pair_kernels.py [--root DIR] [--out PATH]
    python tools/ab_pair_kernels.py --ab PARENT_DIR [--out PATH]

With ``--root`` (default: this checkout) it imports
``gym_formation_tpu_torch`` from DIR, builds its kernels, and prints one
JSON line:

- ``k6_ms``: K6 at the hd_obs colliding subset of N=243 (E=246), B=4096,
  on the positions of a fresh ``formation_hd_obs_env`` batch;
- ``k3_ms``: K3 at N=243, B=4096, the in-kernel BFS, ``stats="pre"``, on a
  fresh ``formation_hd_env`` batch;
- ``fused``: env-steps/s of the fused path (``rollout_statepolicy_fused``,
  ``policy="bfs_ez"``, ``stats="pre"``, N=243, B=4096; K3 once a step) and
  ``hd_obs``: of the hd_obs path (``formation_hd_obs_env``, N=243, B=4096,
  a linear policy; K6 once a step), each the median of 3 windows closed by
  a host fetch, with the host's enqueue ms a step beside;
- ``sass``: for ``pairforce_kernel`` and ``fused_step_kernel``, each loop of
  the compiled code (a backward branch) that holds an exp (``MUFU.EX2``):
  its instruction count, the exps in it (one a pair evaluation), and the
  count of each kind of instruction.  From ``cuobjdump -sass`` of the built
  library; ``null`` where the toolkit has no ``cuobjdump``.

Each time is the mean of 20 launches by CUDA events, after a warm-up.

With ``--ab PARENT_DIR`` it runs itself on PARENT_DIR and on this checkout
in turns (parent, change, change, parent), one process each, and prints the
four lines and the means.  ``--out`` writes the lines as JSON.

Needs a CUDA device and ``nvcc``; exits 1 without a device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
KERNELS = ("pairforce_kernel", "fused_step_kernel")
B, N = 4096, 243


def time_ms(fn, reps=20):
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rate(window, steps):
    """(env-steps/s, host enqueue ms a step): medians of 3 windows of
    ``steps`` steps, each closed by a host fetch of ``window()``'s result."""
    import torch

    window().cpu()  # warm-up
    rates, enq = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = window()
        enq.append((time.perf_counter() - t0) * 1e3 / steps)
        r.cpu()
        rates.append(B * steps / (time.perf_counter() - t0))
    return statistics.median(rates), statistics.median(enq)


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    return str(cand) if cand.exists() else None


def sass_loops(library: Path):
    """{kernel: [loop, ...]} for the loops that hold an exp."""
    tool = _cuobjdump()
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        # "/*0a30*/   @!P0 BRA 0x950 ;" -> (address, opcode, operands)
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", block):
            ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
        loops = []
        for addr, op, args in ins:
            t = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
            if t is None or int(t.group(1), 16) >= addr:
                continue
            body = [o for a, o, _ in ins if int(t.group(1), 16) <= a <= addr]
            kinds = Counter(o.split(".")[0] if not o.startswith("MUFU") else o for o in body)
            if kinds.get("MUFU.EX2", 0):
                loops.append(dict(start=hex(int(t.group(1), 16)), end=hex(addr), instructions=len(body),
                                  exps=kinds["MUFU.EX2"], kinds=dict(kinds.most_common())))
        out.setdefault(kernel, []).extend(loops)
    return out


def measure(root: Path) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_pair_kernels: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(root))
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core import make_world_cfg
    from gym_formation_tpu_torch.core.physics import _collide_subset
    from gym_formation_tpu_torch.ops import _build
    from gym_formation_tpu_torch.ops.kernels import fused_step as k3
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6

    assert Path(gt.__file__).resolve().is_relative_to(root.resolve()), gt.__file__
    lib = _build.build()
    dev = torch.device("cuda")
    obs = gt.make_vec_env("formation_hd_obs_env", num_envs=B, num_agents=N, device=dev, seed=0)
    _, _, idx, sub = _collide_subset(obs.env.scenario.cfg)
    pos6 = obs.reset_state().pos[:, torch.as_tensor(idx, device=dev)].contiguous()
    hd = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=N, device=dev, seed=0)
    st = hd.reset_state()
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    kw = dict(thresh=0.03, stats="pre", bfs_L=5, ideal_vel=st.ideal_vel, act_scale=5.0)
    k6_ms = time_ms(lambda: k6.collision_forces_batched(pos6, sub))
    k3_ms = time_ms(lambda: k3.fused_hd_step(st.pos[:, :N], st.vel[:, :N], None, st.ideal_shape, cfg, **kw))

    fstate = st

    def fused(steps=32):
        nonlocal fstate
        fstate, r = gt.rollout_statepolicy_fused(hd.env, None, fstate, hd.generator, steps,
                                                 stats="pre", policy="bfs_ez")
        return r.sum(0)

    W = torch.as_tensor(np.random.RandomState(7).normal(size=(obs.env.scenario.obs_dim, 2)),
                        dtype=torch.float32, device=dev) / np.sqrt(obs.env.scenario.obs_dim)
    ostate, o = obs.reset()

    def hd_obs(steps=8):
        nonlocal ostate, o
        rs = torch.zeros(B, device=dev)
        for _ in range(steps):
            ostate, out = obs.step(ostate, torch.clamp(o @ W, -1.0, 1.0))
            o = out.obs
            rs = rs + out.reward.sum(-1)
        return rs

    fused_rate, fused_enq = rate(fused, 32)
    obs_rate, obs_enq = rate(hd_obs, 8)
    return dict(root=str(root), device=torch.cuda.get_device_name(0), E6=pos6.shape[1],
                k6_ms=k6_ms, k3_ms=k3_ms, fused=fused_rate, fused_enqueue_ms=fused_enq,
                hd_obs=obs_rate, hd_obs_enqueue_ms=obs_enq, sass=sass_loops(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--ab", type=Path, default=None, metavar="PARENT_DIR")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.ab is None:
        rows = [measure(args.root)]
        print(json.dumps(rows[0]))
    else:
        rows = []
        for root in (args.ab, REPO, REPO, args.ab):
            proc = subprocess.run([sys.executable, __file__, "--root", str(root)], capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps({k: v for k, v in rows[-1].items() if k != "sass"}))
        for label, pick in (("parent", (0, 3)), ("change", (1, 2))):
            mean = lambda key: sum(rows[i][key] for i in pick) / 2
            print(f"{label}: K6 {mean('k6_ms'):.4f} ms, K3 {mean('k3_ms'):.4f} ms; env-steps/s fused path "
                  f"{mean('fused'):.1f} (enqueue {mean('fused_enqueue_ms'):.4f} ms a step), hd_obs path "
                  f"{mean('hd_obs'):.1f} (enqueue {mean('hd_obs_enqueue_ms'):.4f} ms a step)")
        for label, row in (("parent", rows[0]), ("change", rows[1])):
            for kernel, loops in (row["sass"] or {}).items():
                for lp in loops:
                    print(f"{label} {kernel} loop {lp['start']}-{lp['end']}: {lp['instructions']} instructions, "
                          f"{lp['exps']} exp -> {lp['instructions'] / lp['exps']:.1f} a pair evaluation; "
                          f"{lp['kinds']}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
