"""Profile the PyTorch port's N=243 rollout paths on a CUDA card.

    python tools/profile_torch_fused.py [--num-envs 4096] [--steps 8] [--out PATH]

For the fused path (rollout_statepolicy_fused, policy="bfs_ez",
stats="pre") and the step path (rollout_statepolicy_rewardsum under the
BFS + ezpolicy controller), it prints and writes to ``--out`` (JSON,
default build/profile_torch_fused.json):

- kernels launched per step and kernel time per step (torch.profiler);
- the port's own kernels (K1-K4, the step glue) by name: their ctypes launches are not
  attributed to the host ranges below;
- kernel time per layer (PyTorch's kernels only), and the rest of the
  kernel time.  The layers are the program's marks (``rollout.k3``,
  ``rollout.k2``, ``env.reset``: ``utils.profiling.mark``) and, on the step
  path, which has no mark of its own around them, the physics and the
  policy, each call wrapped here in ``record_function``;
- the step's wall time without the profiler (host clock around a window
  closed by a host fetch), and the device's idle share estimated from the
  two: 1 - kernel time / wall time.

Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


PORT_KERNELS = ("pairforce_sym_kernel", "reward_sym_kernel", "fused_step_kernel", "fused_rollout_kernel",
                "step_reset_kernel")


def _wrap(obj, name, label):
    """Replace obj.name by a wrapper that runs it inside record_function."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)

    setattr(obj, name, wrapped)


def wall_ms(run, steps=32):
    """(wall ms per step, host enqueue ms per step) of ``run(steps)``,
    which enqueues the steps and returns a device tensor to fetch."""
    run(4).cpu()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run(steps)
    enqueue = (time.perf_counter() - t0) * 1e3 / steps
    r.cpu()
    return (time.perf_counter() - t0) * 1e3 / steps, enqueue


def profile_path(name, run, steps, envs, layers, wall):
    """Profile ``run(steps)``; ``wall`` is :func:`wall_ms` of the same path
    measured before the layers were wrapped."""
    run(4).cpu()  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps).cpu()
        torch.cuda.synchronize()
    # Kernels are the device-side events that are not the device-side
    # copies of the record_function ranges; a layer's kernel time is the
    # sum of the kernels launched under its host-side range.
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels, kernel_us = 0, 0.0
    by_kernel = defaultdict(float)
    by_layer = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == cuda and evt.name not in layers:
            kernels += 1
            kernel_us += evt.time_range.elapsed_us()
            by_kernel[evt.name[:80]] += evt.time_range.elapsed_us() / steps / 1e3
        elif evt.device_type == cpu and evt.name in layers:
            by_layer[evt.name] += evt.device_time_total / steps / 1e3
    kernel_ms = kernel_us / steps / 1e3
    ported = {k: v for k, v in by_kernel.items() if k.startswith(PORT_KERNELS)}
    rest = kernel_ms - sum(by_layer.values()) - sum(ported.values())
    out = dict(
        path=name,
        envs=envs,
        kernels_per_step=kernels / steps,
        kernel_ms_per_step=kernel_ms,
        wall_ms_per_step_unprofiled=wall[0],
        host_enqueue_ms_per_step_unprofiled=wall[1],
        idle_share_estimate=1.0 - kernel_ms / wall[0],
        port_kernel_ms_per_step={k.split("(")[0]: v for k, v in ported.items()},
        layer_kernel_ms_per_step=dict(by_layer, rest=rest),
        top_kernels_ms_per_step=dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]),
    )
    print(json.dumps(out, indent=1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--num-agents", type=int, default=243)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="build/profile_torch_fused.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_fused: no CUDA device", file=sys.stderr)
        return 1
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch import env as env_mod
    from gym_formation_tpu_torch.models import bfs as bfs_mod

    dev = torch.device("cuda")
    B, n = args.num_envs, args.num_agents
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi)

    venv = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, device=dev, seed=0)
    e, scen, g = venv.env, venv.env.scenario, venv.generator
    state = {"s": e.reset_state(g, B)}
    policy = lambda s, gen: gt.bfs_actions_from_state(gt.ezpolicy_batched, scen, s, 3)

    def fused(k):
        state["s"], r = gt.rollout_statepolicy_fused(e, None, state["s"], g, k, stats="pre", policy="bfs_ez")
        return r.sum(0)

    def step(k):
        state["s"], r = gt.rollout_statepolicy_rewardsum(e, policy, state["s"], g, k)
        return r

    walls = {"fused": wall_ms(fused), "step": wall_ms(step)}
    _wrap(env_mod, "world_step", "physics")
    _wrap(bfs_mod, "_expand", "policy")
    layers = ("rollout.k3", "rollout.k2", "env.reset", "physics", "policy")
    results = [
        profile_path("fused bfs_ez pre", fused, args.steps, B, layers, walls["fused"]),
        profile_path("step path", step, args.steps, B, layers, walls["step"]),
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, results=results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
