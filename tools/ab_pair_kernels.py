"""Time the port's pair kernels K1, K3, K6 and K8 and count their pair loops' SASS.

    python tools/ab_pair_kernels.py [--root DIR] [--out PATH]
    python tools/ab_pair_kernels.py --ab PARENT_DIR [--out PATH]

With ``--root`` (default: this checkout) it imports
``gym_formation_tpu_torch`` from DIR, builds its kernels, and prints one
JSON line:

- ``k1_ms``: K1 at N=243, B=4096, on the agents of a fresh
  ``formation_hd_env`` batch (the step path's shapes; K1 evaluates every
  pair, so its time does not depend on the positions);
- ``k6_ms``: K6 at the hd_obs colliding subset of N=243 (E=246), B=4096,
  on the positions of a fresh ``formation_hd_obs_env`` batch;
- ``k8_ms``: K8's whole wrapper at N=243, B=4096, on the agents after the
  128 steps of the cull selector path below (the cull path's state), and
  ``k8_near``: the ordered pairs of that state within K8's cutoff;
- ``k3_ms``: K3 at N=243, B=4096, the in-kernel BFS, ``stats="pre"``, on a
  fresh ``formation_hd_env`` batch;
- ``fused``: env-steps/s of the fused path (``rollout_statepolicy_fused``,
  ``policy="bfs_ez"``, ``stats="pre"``, N=243, B=4096; K3 once a step),
  ``hd_obs``: of the hd_obs path (``formation_hd_obs_env``, N=243, B=4096,
  a linear policy; K6 once a step), ``step``: of the step path
  (``rollout_statepolicy_rewardsum`` under the BFS + ezpolicy controller,
  N=243, B=4096; K1 once a step) and ``cull``: of the same path under
  ``set_pallas_impl("cull")`` (K8 once a step), each the median of 3 windows
  closed by a host fetch after one warm-up window, with the host's enqueue
  ms a step beside;
- ``sass``: for the kernels of K1, K3, K6 and K8, each loop of
  the compiled code (a backward branch) that holds an exp (``MUFU.EX2``):
  its instruction count, the exps in it (one a pair evaluation), and the
  count of each kind of instruction.  From ``cuobjdump -sass`` of the built
  library; ``null`` where the toolkit has no ``cuobjdump``.

Each time is the mean of 20 launches by CUDA events, after a warm-up.

With ``--ab PARENT_DIR`` it runs itself on PARENT_DIR and on this checkout
in turns (parent, change, change, parent), one process each, and prints the
four lines and the means.  ``--out`` writes the lines as JSON.

With ``--k8-phases`` it times K8 by phase instead: it copies
``gym_formation_tpu_torch`` into ``build/k8_phases/<variant>/``, takes
phases out of the copy's ``csrc/pairforce_cull.cu``, and times each copy's
K8 on the cull path's state (one process a copy, the full kernel first and
last): ``full``; ``no_pairs``, without the pair loop (the grid and the
sort only); ``no_place``, without the pair loop and with the one warp's
placement by cell replaced by a placement in index order.  A phase's time
is the difference of two copies': the phases overlap on the card, so the
shares are estimates.  The copies compute wrong results and serve only
this timing.

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
PKG = "gym_formation_tpu_torch"
KERNELS = ("pairforce_sym_kernel", "fused_step_kernel", "pairforce_kernel", "pairforce_cull_kernel")
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


def cull_state(gt, hd, policy, state, set_pallas_impl):
    """The step path under ``set_pallas_impl("cull")`` from ``state``, as
    ``rate`` measures it (4 windows of 32 steps): (env-steps/s, enqueue ms a
    step, the state after the 128 steps: the cull path's state)."""
    box = [state]

    def step(steps=32):
        box[0], r = gt.rollout_statepolicy_rewardsum(hd.env, policy, box[0], hd.generator, steps)
        return r

    set_pallas_impl("cull")
    try:
        steps_per_s, enqueue_ms = rate(step, 32)
    finally:
        set_pallas_impl("auto")
    return steps_per_s, enqueue_ms, box[0]


K8_LOOP = "#pragma unroll 2\n        for (int j = j0; j < j1; ++j) {"
K8_LOOP_END = "          fy += w * (g * dy);\n        }\n"
K8_PLACE = "  if (warp == 0) {\n    for (int base = (E - 1) & ~31;"
K8_PLACE_END = "      __syncwarp();\n    }\n  }\n"
K8_VARIANTS = ("full", "no_pairs", "no_place", "full")


def k8_patch(src: str, variant: str) -> str:
    if variant in ("no_pairs", "no_place"):
        i = src.index(K8_LOOP)
        src = src[:i] + src[src.index(K8_LOOP_END, i) + len(K8_LOOP_END):]
    if variant == "no_place":
        i = src.index(K8_PLACE)
        j = src.index(K8_PLACE_END, i) + len(K8_PLACE_END)
        src = src[:i] + "  for (int e = tid; e < E; e += nt) orig[e] = e;\n" + src[j:]
    return src


def measure_k8(root: Path) -> dict:
    """K8's time by CUDA events and the host's enqueue a launch on the cull
    path's state."""
    import torch

    sys.path.insert(0, str(root))
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core import make_world_cfg, set_pallas_impl
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    assert Path(gt.__file__).resolve().is_relative_to(root.resolve()), gt.__file__
    dev = torch.device("cuda")
    hd = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=N, device=dev, seed=0)
    policy = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, hd.env.scenario, s, 3)
    _, _, st = cull_state(gt, hd, policy, hd.reset_state(), set_pallas_impl)
    pos = hd.env.scenario.agent_pos(st).contiguous()
    cfg = make_world_cfg(N, 0, agent_size=0.03)
    fn = lambda: k8.collision_forces_culled(pos, cfg)
    ms = time_ms(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 20  # before the device is waited for
    torch.cuda.synchronize()
    return dict(k8_ms=ms, k8_enqueue_ms=enqueue_ms)


def k8_phases(out) -> int:
    base = REPO / "build" / "k8_phases"
    src = (REPO / PKG / "csrc" / "pairforce_cull.cu").read_text()
    rows, made = [], set()
    for variant in K8_VARIANTS:
        root = base / variant
        if variant not in made:
            made.add(variant)
            shutil.rmtree(root, ignore_errors=True)
            shutil.copytree(REPO / PKG, root / PKG, ignore=shutil.ignore_patterns("__pycache__"))
            (root / PKG / "csrc" / "pairforce_cull.cu").write_text(k8_patch(src, variant))
        proc = subprocess.run([sys.executable, __file__, "--k8-root", str(root)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rows.append(dict(variant=variant, **json.loads(proc.stdout.strip().splitlines()[-1])))
        print(json.dumps(rows[-1]), flush=True)
    full = (rows[0]["k8_ms"] + rows[-1]["k8_ms"]) / 2
    by = {r["variant"]: r["k8_ms"] for r in rows}
    print(f"K8 on the cull path's state: full {full:.4f} ms; pair loop {full - by['no_pairs']:.4f}, placement "
          f"by cell {by['no_pairs'] - by['no_place']:.4f}, the rest (loads, box, grid, histogram, scan, gather, "
          f"stores) {by['no_place']:.4f} (host enqueue {rows[-1]['k8_enqueue_ms']:.4f} ms a launch)")
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return 0


def measure(root: Path) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_pair_kernels: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(root))
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core import make_world_cfg, set_pallas_impl
    from gym_formation_tpu_torch.core.physics import _collide_subset
    from gym_formation_tpu_torch.ops import _build
    from gym_formation_tpu_torch.ops.kernels import fused_step as k3
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8
    from gym_formation_tpu_torch.ops.kernels import pairforce_sym as k1

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
    pos1 = st.pos[:, :N].contiguous()
    k1_ms = time_ms(lambda: k1.collision_forces_sym(pos1, cfg))

    policy = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, hd.env.scenario, s, 3)
    sstate = st

    def step(steps=32):
        nonlocal sstate
        sstate, r = gt.rollout_statepolicy_rewardsum(hd.env, policy, sstate, hd.generator, steps)
        return r

    step_rate, step_enq = rate(step, 32)
    cull_rate, cull_enq, cstate = cull_state(gt, hd, policy, st, set_pallas_impl)  # after 128 steps
    pos8 = hd.env.scenario.agent_pos(cstate).contiguous()
    k8_ms = time_ms(lambda: k8.collision_forces_culled(pos8, cfg))
    d = pos8[:, :, None, :] - pos8[:, None, :, :]
    k8_near = int(((d * d).sum(-1) < k8.cutoff(cfg) ** 2).sum()) - B * N

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
                k1_ms=k1_ms, k3_ms=k3_ms, k6_ms=k6_ms, k8_ms=k8_ms, k8_near=k8_near,
                fused=fused_rate, fused_enqueue_ms=fused_enq, hd_obs=obs_rate, hd_obs_enqueue_ms=obs_enq,
                step=step_rate, step_enqueue_ms=step_enq, cull=cull_rate, cull_enqueue_ms=cull_enq,
                sass=sass_loops(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--ab", type=Path, default=None, metavar="PARENT_DIR")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--k8-phases", action="store_true")
    ap.add_argument("--k8-root", type=Path, default=None, help=argparse.SUPPRESS)  # one copy, in a child
    args = ap.parse_args()
    if args.k8_root is not None:
        print(json.dumps(measure_k8(args.k8_root)))
        return 0
    if args.k8_phases:
        return k8_phases(args.out)
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
            print(f"{label}: K1 {mean('k1_ms'):.4f} ms, K3 {mean('k3_ms'):.4f} ms, K6 {mean('k6_ms'):.4f} ms, "
                  f"K8 {mean('k8_ms'):.4f} ms; env-steps/s (enqueue ms a step): step path {mean('step'):.1f} "
                  f"({mean('step_enqueue_ms'):.4f}), cull path {mean('cull'):.1f} ({mean('cull_enqueue_ms'):.4f}), "
                  f"fused path {mean('fused'):.1f} ({mean('fused_enqueue_ms'):.4f}), hd_obs path "
                  f"{mean('hd_obs'):.1f} ({mean('hd_obs_enqueue_ms'):.4f})")
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
