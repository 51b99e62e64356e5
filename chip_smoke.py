"""Drive the PyTorch port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. Environment: the card's name and power limit, the torch and CUDA
   versions.  Without a CUDA device the script exits 1 and prints no result.
2. Build: compiles the CUDA kernels under gym_formation_tpu_torch/csrc/
   into build/kernels/ (at first use) and prints the build seconds.
3. K1 (pair forces) against its plain PyTorch version on the card.
4. K2 (reward statistics) against its plain PyTorch version on the card.
5. Main path: make_vec_env("formation_hd_env", num_envs=4096,
   num_agents=243) stepped 128 steps under the BFS + ezpolicy controller by
   rollout_statepolicy_rewardsum, across one auto-reset (world_length 100).
   Both kernels' launch counters must rise by exactly the number of steps,
   and the reward sums must be finite.  The same path on a small injected
   state must agree with the CPU run of the plain versions.  Prints
   env-steps/s (median of 3 windows, each closed by a host fetch) and each
   kernel's time beside its plain version's at B=4096 (CUDA events).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

STEPS = 128
NUM_ENVS = 4096
NUM_AGENTS = 243


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print(f"== {name}", flush=True)


def max_err(got, want):
    return float((got.double() - want.double()).abs().max())


def check_close(got, want, atol, rtol, what):
    err = (got.double() - want.double()).abs()
    bound = atol + rtol * want.double().abs()
    require(bool(torch.all(err <= bound)), f"{what}: kernel and plain disagree (max abs err {err.max():.3e})")
    return float(err.max())


def time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel_fn, plain_fn):
    """(kernel ms, plain ms) measured in turns: plain, kernel, kernel, plain."""
    p1 = time_ms(plain_fn, 3)
    k1 = time_ms(kernel_fn, 20)
    k2 = time_ms(kernel_fn, 20)
    p2 = time_ms(plain_fn, 3)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    # -- 1. environment --------------------------------------------------
    phase("environment")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core import make_world_cfg
    from gym_formation_tpu_torch.ops import _build
    from gym_formation_tpu_torch.ops.kernels import pairforce_sym as k1
    from gym_formation_tpu_torch.ops.kernels import reward_sym as k2

    dev = torch.device("cuda")

    # -- 2. build --------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"build {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path)} "
          f"(cached={_build.build_info.get('cached')})")
    ptxas = _build.build_info.get("ptxas", "")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    rng = np.random.RandomState(0)

    # -- 3. K1 -----------------------------------------------------------
    phase("K1 pairforce_sym vs plain")
    cfg = make_world_cfg(NUM_AGENTS, 0, agent_size=0.03)  # the hd colliding subset
    p = k1._params(cfg)
    k1_err = 0.0
    for B in (512, NUM_ENVS, 5):
        pos = rng.uniform(-0.5, 0.5, (B, NUM_AGENTS, 2)).astype(np.float32)
        if B == 5:  # exact contact, deep penetration, zero distance
            pos[:, 1] = pos[:, 0] + np.float32([0.04, 0.0])
            pos[:, 2] = pos[:, 0] + np.float32([0.0, 0.0601])
            pos[:, 3] = pos[:, 4]
        pos = torch.as_tensor(pos, device=dev)
        got = k1.collision_forces_sym(pos, cfg)
        want = k1.collision_forces_sym_plain(pos, **p)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"K1 B={B}: non-finite forces")
        k1_err = max(k1_err, check_close(got, want, 1e-3, 1e-3, f"K1 B={B}"))
        print(f"K1 B={B} E={NUM_AGENTS}: max abs err {max_err(got, want):.3e} (atol=rtol=1e-3)")

    # -- 4. K2 -----------------------------------------------------------
    phase("K2 reward_sym vs plain")
    thresh = 0.03
    k2_err = 0.0
    for B, scale in ((512, 1.0), (512, 0.05), (NUM_ENVS, 0.05)):
        apos = torch.as_tensor(rng.uniform(-1, 1, (B, NUM_AGENTS, 2)) * scale, dtype=torch.float32, device=dev)
        ishape = torch.as_tensor(rng.uniform(-1, 1, (B, NUM_AGENTS, 2)), dtype=torch.float32, device=dev)
        ishape = (ishape - ishape.mean(1, keepdim=True)).contiguous()
        h, nc = k2.hd_reward_stats_sym(apos, ishape, thresh=thresh)
        h_p, nc_p = k2.hd_reward_stats_sym_plain(apos, ishape, thresh=thresh)
        torch.cuda.synchronize()
        k2_err = max(k2_err, check_close(h, h_p, 1e-5, 0.0, f"K2 haus B={B} scale={scale}"))
        require(torch.equal(nc, nc_p), f"K2 counts B={B} scale={scale}: kernel and plain differ")
        if scale < 1.0:
            require(int(nc.sum()) > 0, "K2: the squeezed fixture has no collisions")
        print(f"K2 B={B} N={NUM_AGENTS} scale={scale}: haus max abs err {max_err(h, h_p):.3e} "
              f"(atol 1e-5), counts equal ({int(nc.sum())} collisions)")

    # -- 5. main path ----------------------------------------------------
    phase("main path")
    venv = gt.make_vec_env("formation_hd_env", num_envs=NUM_ENVS, num_agents=NUM_AGENTS,
                           device=dev, seed=0)
    scen = venv.env.scenario
    policy = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, scen, s, 3)
    state = venv.reset_state()
    torch.cuda.synchronize()
    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    state, rsum = gt.rollout_statepolicy_rewardsum(venv.env, policy, state, venv.generator, STEPS)
    rsum_host = rsum.cpu()
    first_run_s = time.perf_counter() - t0
    launches = {"pairforce_sym": k1.launches, "reward_sym": k2.launches}
    print(f"{STEPS} steps at N={NUM_AGENTS} B={NUM_ENVS}: {first_run_s:.2f} s, launches {launches}")
    for name, n in launches.items():
        require(n == STEPS, f"{name}: {n} launches in {STEPS} steps of the main path")
    require(tuple(rsum_host.shape) == (NUM_ENVS,), f"reward sum shape {tuple(rsum_host.shape)}")
    require(bool(torch.isfinite(rsum_host).all()), "non-finite reward sums")
    require(bool(torch.isfinite(state.pos).all()) and bool(torch.isfinite(state.vel).all()),
            "non-finite state")
    t_host = state.t.cpu()
    require(bool(torch.all(t_host == STEPS - venv.env.world_length)),
            f"episode counters after the auto-reset: {t_host.unique().tolist()}")
    print(f"reward sum per env: mean {float(rsum_host.mean()):.4f} "
          f"min {float(rsum_host.min()):.4f} max {float(rsum_host.max()):.4f}")

    # The same path on small injected states, on the card (kernels) and on
    # the CPU (plain versions); tolerances of tests/test_fused_step.py.
    for n, B, T in ((27, 16, 8), (NUM_AGENTS, 4, 2)):
        small = gt.make_env("formation_hd_env", num_agents=n)
        srng = np.random.RandomState(n)
        apos = srng.uniform(-1, 1, (B, n, 2))
        ishape = srng.uniform(-1, 1, (B, n, 2))
        ishape -= ishape.mean(1, keepdims=True)
        st = dict(
            pos=np.concatenate([apos, ishape + apos.mean(1, keepdims=True)], 1),
            vel=np.zeros((B, 2 * n, 2)), c=np.zeros((B, n, 2)), ideal_shape=ishape,
            ideal_vel=srng.uniform(-1, 1, (B, 2)), t=np.zeros(B, np.int32),
        )
        pol = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, small.scenario, s, 3)
        out = {}
        for d in ("cuda", "cpu"):
            g = torch.Generator(device=d)
            g.manual_seed(1)
            fin, rew = gt.rollout_statepolicy(small, pol, gt.state_from_numpy(st, device=d), g, T)
            out[d] = (fin.pos.cpu(), fin.vel.cpu(), rew.cpu())
        (cp, cv, cr), (pp, pv, pr) = out["cuda"], out["cpu"]
        check_close(cp, pp, 2e-4, 1e-4, f"slice N={n} pos")
        check_close(cv, pv, 2e-3, 1e-4, f"slice N={n} vel")
        check_close(cr, pr, 1e-4, 1e-5, f"slice N={n} reward")
        print(f"slice N={n} B={B} T={T}: card vs CPU plain agree "
              f"(pos {max_err(cp, pp):.2e}, vel {max_err(cv, pv):.2e}, reward {max_err(cr, pr):.2e})")

    # Throughput: 3 windows, each closed by a host fetch of the reward sums.
    # The host time to enqueue a window, before the fetch waits for the
    # device, says how close the Python launch path is to the device time.
    window = 32
    rates, enqueue_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rs = gt.rollout_statepolicy_rewardsum(venv.env, policy, state, venv.generator, window)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3 / window)
        rs_host = rs.cpu()
        dt = time.perf_counter() - t0
        require(bool(torch.isfinite(rs_host).all()), "non-finite reward sums in a timed window")
        rates.append(NUM_ENVS * window / dt)
    rate = statistics.median(rates)
    print(f"env-steps/s N={NUM_AGENTS} B={NUM_ENVS}: median {rate:.1f} "
          f"(windows of {window} steps: {', '.join(f'{r:.1f}' for r in rates)})")
    print(f"host enqueue ms/step: median {statistics.median(enqueue_ms):.3f} "
          f"(step wall {NUM_ENVS / rate * 1e3:.3f} ms)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Kernel against plain at the main path's shapes.
    pos = scen.agent_pos(state).contiguous()
    k1_ms, k1_plain_ms = time_pair(lambda: k1.collision_forces_sym(pos, cfg),
                                   lambda: k1.collision_forces_sym_plain(pos, **p))
    ishape = state.ideal_shape.contiguous()
    k2_ms, k2_plain_ms = time_pair(lambda: k2.hd_reward_stats_sym(pos, ishape, thresh=thresh),
                                   lambda: k2.hd_reward_stats_sym_plain(pos, ishape, thresh=thresh))
    print(f"K1 B={NUM_ENVS}: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    print(f"K2 B={NUM_ENVS}: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")

    kernels = [
        dict(name="pairforce_sym", route="cuda", source="gym_formation_tpu_torch/csrc/pairforce_sym.cu",
             replaces="gym_formation_tpu/ops/pallas/pairforce_sym.py:264",
             launches=launches["pairforce_sym"], max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms),
        dict(name="reward_sym", route="cuda", source="gym_formation_tpu_torch/csrc/reward_sym.cu",
             replaces="gym_formation_tpu/ops/pallas/reward_sym.py:183",
             launches=launches["reward_sym"], max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
