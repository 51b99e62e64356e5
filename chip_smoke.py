"""Drive the PyTorch port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:

1. Environment: the card's name and power limit, the torch and CUDA
   versions.  Without a CUDA device the script exits 1 and prints no result.
2. Build: compiles the CUDA kernels under gym_formation_tpu_torch/csrc/
   into build/kernels/ (at first use) and prints the build seconds.
3. K1 (pair forces) against its plain PyTorch version on the card: N=243
   at B=512 and 4096, exact contact and zero distance, and every pair in
   contact (all agents within 0.04, the contact distance 0.06).
4. K2 (reward statistics) against its plain PyTorch version on the card.
5. Step path: make_vec_env("formation_hd_env", num_envs=4096,
   num_agents=243) stepped 128 steps under the BFS + ezpolicy controller by
   rollout_statepolicy_rewardsum, across one auto-reset (world_length 100).
   K1's and K2's launch counters must rise by exactly the number of steps,
   and the reward sums must be finite.  The same path on a small injected
   state must agree with the CPU run of the plain versions.  Prints
   env-steps/s (median of 3 windows, each closed by a host fetch) and each
   kernel's time beside its plain version's at B=4096 (CUDA events).
6. K3 (fused step) against its plain version on the card: N=243, B=512 and
   4096, pre and post statistics, external actions and the in-kernel BFS,
   and a squeezed fixture with collisions; counts exact.
7. K4 (whole rollout) against its plain version at every instantiated n:
   n=3, B=4096 over 120 steps; n=4 and n=9, B=4096 over 50 steps; n=3, 4
   and 9 at the ragged B=37 (the last warp's env groups partly empty). The
   episode counters are spread so that every env resets; within the
   tolerances of tests/test_fused_rollout.py and bit for bit.
8. Fused path: rollout_statepolicy_fused(policy="bfs_ez", stats="pre") at
   N=243, B=4096 for 128 steps across one auto-reset.  K3 and the step glue
   (step_reset) launch once a step, K2 (masked reset recompute) once a step
   and once to finalize, K1 never.  Finite rewards, episode counters after
   the reset, and the card against the CPU plain path on small injected
   states.  Prints env-steps/s and host enqueue ms/step as phase 5 does, and
   K3's time beside its plain version's; K3's split on the path's state (K3
   with external actions, K3 with the in-kernel BFS, K1 alone, K2 alone)
   beside its special-function bound; K2's masked form beside an
   unconditional recompute.  The step glue against its plain version on the
   path's state and K3's outputs, the episode counters spread so that one
   env in 100 resets: agents, velocities, ideal velocity, counters and done
   bit for bit, landmarks, shape and velocity term within 3e-5; its time
   beside the plain version's.
9. N=3 path: fused_rollout_hd at n=3, B=4096, length 256 (one K4 launch a
   window); env-steps/s as above, and K4's time beside its plain version's,
   K4 at n=9 (B=4096, 256 steps), each beside its bound, its no-FMA floor
   and its special-function floor (``k4_floors``).
10. K5 (MAPPO collection) against its plain version: n=3, B=4096, T=25,
   ep_len 10 with the episode counters spread so that every env resets;
   trajectory and state within tolerance, done and counters exact, stored
   logp and value against the networks re-applied.  The same gates at n=9,
   B=4096 (tiles of 4 envs, several persistent waves).  Kernel and plain
   times of both.
11. K9 (PPO epoch gradient) against its plain version on a real K5
   trajectory after _prepare (M = 102,400), every gradient leaf within rtol
   2e-3, atol 2e-6, two runs bit for bit, and the learner's epoch gradient
   against autograd of its loss.  Kernel and plain times.
12. MAPPO N=3 path: MAPPO(make_env("formation_hd_env", num_agents=3),
   MAPPOConfig(fused_update=True), num_envs=4096) on the card; the auto gate
   must turn fused_collect on.  One warm-up and 3 timed train_step calls,
   each closed by a host fetch of the metrics: K5 once and K9 ppo_epochs
   times an iteration, K1-K4 never.  Prints training env-steps/s and the
   collect / prepare / update split (CUDA events), the same with the
   autograd update, the card against the CPU plain versions on one small
   iteration, and mean_step_reward over 12 iterations.
13. MAPPO N=243 structured path: B=1024, the default config, so the auto
   gate takes the obs-free path.  One warm-up and 3 timed iterations: K1
   and K2 once an env step, K5 and K9 never, no call of observe.  Prints
   env-steps/s, agent-steps/s, the split and the peak device memory, and
   one structured_bf16 iteration's time.

14. K6 (dense pair forces) against its plain version: the hd_obs colliding
   subset at N=243 (E=246: agents of size 0.1, obstacles of size 0.15) at
   B=512 and 4096, the heterogeneous fixture of tests/test_pallas.py (mass
   2.5, an immovable block, a non-colliding block), and exact contact and
   zero distance; atol = rtol = 1e-3.
15. K7 (row-major reward statistics) against its plain version and against
   K2 on phase 4's fixtures: Hausdorff atol 1e-5 (1e-6 against K2), counts
   exact.
16. K8 (culled pair forces, a per-env grid of cells built in the kernel)
   against its plain version (1e-3) and K6 (atol 2e-4, rtol 1e-4) at E=243
   and 246, B=4096, dense and spread; its evaluated pairs against the plain
   grid's candidates and the near pairs.  Prints the candidates against the
   near pairs and against E(E-1), and the wrapper's time (one launch).
17. hd_obs path: make_vec_env("formation_hd_obs_env", num_envs=4096,
   num_agents=243) stepped 128 steps (world_length 50, so auto-resets are
   crossed) under bench.py's linear policy clip(obs @ W, -1, 1).  K6 once a
   step, K1 never; finite rewards; the obstacles fall; the card against the
   CPU plain path on a small injected state.  Prints env-steps/s, the peak
   device memory, one N=27 window, and K6's time beside its plain version's.
18. Selector paths: the step path of phase 5 for 32 steps each under
   set_pallas_impl("cull") (K8 once a step, K1 never),
   set_pallas_impl("dense") (K6 once a step, K1 never) and
   set_reward_impl("rowmajor") (K7 once a step, K2 never); per-step rewards
   against the default selectors' from the same states; env-steps/s; K8's
   and K7's times at the paths' shapes.  The selectors are restored after.
19. The other scenarios: the two partial scenarios (N=27, the linear
   policy) at B=4096, K1 once a step (basic_formation_env N=3 is the
   bench's row 3, phase 42).
20. K1 and K2 against their plain versions at the N=3 paths' shape (the hd
   colliding subset of 3 agents) at B=32 (the off-policy zoo), 128 and 512:
   random states, pairs in exact contact, at K2's threshold and at zero
   distance, all agents in contact; K1 atol = rtol = 1e-3, K2 Hausdorff
   atol 1e-5 and counts equal, two launches bit for bit.  Each kernel's
   time at n=3, B=32 and 512, beside its plain version's and its bound.
21. RMAPPO N=3 path: RMAPPO(make_env("formation_hd_env", num_agents=3,
   episode_length=25), RMAPPOConfig(), num_envs=128), the reference's tuned
   configuration (GRU 64, chunks of 5, 10 epochs).  One warm-up and 3 timed
   train_step calls: K1 and K2 once an env step, K3-K9 never.  Training
   env-steps/s and the collect / prepare / update split (CUDA events); one
   _update_recurrent on the card against the CPU from the same networks on
   the same batch and permutations; mean_step_reward over 12 iterations.
22. Discrete MAPPO N=3 path (the categorical head) at B=512: as phase 21,
   and every sampled action a one-hot.
23. Separated MAPPO N=3 path (share_policy=False) at B=512: as phase 21.
24. eval: python -m gym_formation_tpu_torch.eval --policy ckpt --algo rmappo
   on a checkpoint of phase 21's learner, 2 episodes on the card, finite
   returns.
25. MADDPG N=3 path: make_algo("maddpg", make_env("formation_hd_env",
   num_agents=3), 32 envs) with MADDPGConfig() (the reference's zoo
   protocol: hidden (64, 64, 64), batch 256, a buffer of 500,000, 32 env
   steps and 32 updates an iteration).  One warm-up and 3 timed train_step
   calls, each closed by a host fetch of the metrics: K1 and K2 once an
   env step (96 launches), K3-K9 never.  Training env-steps/s, the
   collect / update split (CUDA events), the peak device memory; two
   _update_once calls on the card against the CPU from the same networks,
   batches and draws; mean_step_reward over 12 iterations finite and above
   ZOO_FLOOR (the reference's own learners leave the on-policy band).
   Beside it, 3 timed iterations each (launches, rate, split, memory) of
   DDPG (local critics), discrete MADDPG (every stored action a one-hot)
   and MADDPG with use_per and ou_noise (priorities finite and positive,
   importance weights in (0, 1]).
26. MATD3 N=3 path, continuous as phase 25 (on the second update the delay
   skips, the card's actor stays as it was), and discrete beside it.
27. MASAC N=3 path, continuous as phase 25 and discrete beside it; α moves
   from init_alpha.
28. QMIX N=3 path on the discrete env, QMixConfig() defaults (a buffer of
   200,000, 8 updates an iteration), as phase 25; VDN beside it.
29. eval: python -m gym_formation_tpu_torch.eval --policy ckpt of phase 25's
   MADDPG and phase 28's QMIX learners, 2 episodes each on the card, finite
   returns.
30-34. The recurrent off-policy zoo at N=3: make_algo(name,
   make_env("formation_hd_env", num_agents=3, episode_length=25), 32 envs)
   for rmaddpg, rmatd3, rmasac, rqmix and rvdn with their configs'
   defaults (the reference's recurrent zoo protocol: 4096 episodes
   buffered, batches of 32 episodes, 8 collections of 32 fresh episodes and
   4 updates an iteration, GRU 64, critic (64, 64, 64)).  One warm-up and 3
   timed train_step calls, each closed by a host fetch of the metrics: K1
   and K2 once an env step (600 launches), K3-K9 never.  Training
   env-steps/s (6,400 env steps an iteration), the collect / update split
   (CUDA events), the peak device memory beside the episode buffer's bytes;
   two _update_once calls on the card against the CPU from the same
   networks, episodes (made with numpy) and draws; mean_step_reward over 12
   iterations from a fresh learner finite and above RECURRENT_FLOOR.
35. eval: python -m gym_formation_tpu_torch.eval --policy ckpt of phase 30's
   RMADDPG and phase 33's RQMIX learners, 2 episodes each on the card with
   the recurrent carry threaded, finite returns.
36. The imperative surface: GymMultiAgentEnv("formation_hd_env",
   num_agents=9) with no device argument, so on the card, from
   compat.host_reset(seed=1) injected into its state: 10 steps under
   get_action_BFS(ezpolicy, obs, 3) against the same wrapper on the CPU
   from the same state (observations, rewards and the info quartet within
   the env's card-against-CPU tolerances of phase 5, done flags exactly),
   then 90 more steps finite; K1 and K2 exactly once a step.  DictAgentEnv
   5 steps with its keys and __all__.  render_state, render_state_per_agent
   and tile_images of the card state: uint8 of the right shapes; the
   renderer's ms a 350-px frame at N=9 and N=243.  The wrapper's steps/s,
   median of 3 windows of 100 steps.
37. The demo: python -m gym_formation_tpu_torch.demo -n 3 --num-layer 5
   --steps 20 --gif (N=243 on the card): exit 0, finite first and last
   rewards, the GIF's path or the "imageio unavailable" line.
38. eval --policy ckpt --gif --per-agent-view --episodes 1 of phase 21's
   RMAPPO checkpoint: a finite return, the GIF's path or the imageio line.
39. Profiling: trace() around 8 steps of the step path (N=243, B=4096)
   inside named_scope("step"): the trace file names the scope and holds
   K1's and K2's CUDA kernels once a step (no CUDA kernel event fails the
   phase); assert_finite passes the state and names .vel on a copy with
   one NaN; Throughput reports a positive rate; the traced window's wall
   against untraced ones.

40. Data parallel (gym_formation_tpu_torch.parallel): K5 at env_offset
   2048 over B=2048 (rank 1 of 2 at B=4096) against its plain version, and
   against rows [2048, 4096) of one launch over the whole batch; then a
   world of 2 processes on the one card (backend gloo, chosen explicitly:
   NCCL refuses two ranks on one device), each path against this process's
   unsharded run from the same seed: the sharded fused rollout (N=243,
   B=4096, 128 steps, bfs_ez; the gathered rewards and final state bit for
   bit; K3 128 and the masked K2 129 launches a rank), MAPPO N=3 fused
   (B=4096, 3 iterations; K5 once an iteration and K9 once an epoch a rank;
   parameters within rtol 5e-3 atol 5e-5, the first optimizer step's
   reduced gradient within rtol 5e-3 and 1e-4 of its largest entry), MAPPO
   N=243 structured (B=1024, 2 iterations; K1 and K2 once an env step a
   rank; the first step's gradient so held; Adam's sign-like steps spread
   weights with near-zero gradients by up to 2·lr a step, so the
   parameters are reported and held only within that) and MADDPG N=3
   (B=32, 2 iterations; both ranks' parameters bit for bit); then a
   world of 1 (nccl) running MAPPO N=3 fused for 2 iterations against the
   unsharded run.  Prints the training env-steps/s of W=2 and W=1 and the
   collectives' ms an iteration (CUDA events) beside the card's name and
   power limit.
41. Tensor parallel (gym_formation_tpu_torch.parallel.tensor, the 'model'
   axis): a world of 2 processes on the one card (gloo) on the mesh
   ``{'data': 1, 'model': 2}``, each rank holding its slices of the cut
   parameters and their moments, against this process: MAPPO N=3 fused
   (B=4096, 3 iterations; K5 on weights gathered whole once an iteration,
   K9 once an epoch with its gradients cut to the rank's slices; phase
   40's unsharded run), MAPPO N=243 structured (B=1024, one iteration of
   one epoch; K1 and K2 once an env step; the critic's [354294, 64] first
   kernel cut in two; the step's gradient within rtol 5e-3 and 1e-4 of its
   largest entry, the parameters' spread reported), RMAPPO N=3 (B=128, 2
   iterations; K1 and K2 once an env step) and MADDPG N=3 (B=32, 2
   iterations; phase 40's unsharded run); N=3 parameters within rtol 5e-3
   atol 5e-5, both ranks' replicated leaves bit for bit.  Prints each
   rank's held parameter and moment bytes against the whole, the model
   axis's collectives' calls and ms an iteration (CUDA events) and the
   training env-steps/s of TP=2 and one process.

42. The bench and the graft entry: ``python -m
   gym_formation_tpu_torch.bench`` with no arguments in its own process
   (three JSON lines in SUITE order with emit's keys and the rows' metrics,
   finite rates > 0) and its row 2 under ``--mesh 1`` (an nccl world of one
   rank, 2 chunks); each SUITE row again through ``bench.run`` in this
   process (2 chunks a window, one window) with its launches counted: row 1
   K4 once a chunk and nothing else, row 2 K3 and the step glue once a step
   and the masked K2 once a step and once a chunk with neither K1 nor the
   PyTorch BFS, row 3 K1 once a step; ``--fused on`` at n=5 refused with no
   launch; K1 against its plain version at row 3's configuration
   (basic_formation N=3, agents of size 0.1, B=4096: the row's seed-0
   reset, exact contact, deep penetration, zero distance, all in contact;
   atol = rtol = 1e-3, two launches bit for bit); ``graft_entry.entry()``'s
   forward (MAPPO at N=9, 64 envs) on the card against the CPU within atol
   = rtol = 1e-5.
43. The learning hold: MAPPO N=3 at B=1024 through ``train_step`` with
   the fused collection (K5, by the auto gate) and the fused update (K9),
   80 iterations (2,048,000 env steps) from seed 1 as ``python -m
   gym_formation_tpu_torch.train`` seeds it: K5 exactly 80 launches, K9
   800, every other kernel 0, and the mean ``mean_step_reward`` of
   iterations 76-80 inside ``HOLD_BAND``, fixed from the three seeds of the
   curve ``tools/learning_curves.py`` holds on this route
   (``runs/torch_mappo_n3_fused_s{1,2,3}``): their values at 2,048,000
   steps, min to max, widened by a quarter of the reference's improvement.

Each path is driven with every launch counter set to 0 just before it and
read just after.

The line before the last is a JSON object with one entry per kernel, each
with its least possible time on the card (``bound_ms``, see ``bound``); the
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
THRESH = 0.03  # the hd collision distance: (s1 + s2) / 2 with agent size 0.03
WINDOW = 32  # steps per timed window of the N=243 paths
N3_LENGTH = 256  # steps per K4 call of the N=3 path


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


def time_pair(kernel_fn, plain_fn, plain_reps=3):
    """(kernel ms, plain ms) measured in turns: plain, kernel, kernel, plain."""
    p1 = time_ms(plain_fn, plain_reps)
    k1 = time_ms(kernel_fn, 20)
    k2 = time_ms(kernel_fn, 20)
    p2 = time_ms(plain_fn, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def reset_counts(*mods):
    for m in mods:
        m.launches = 0


def throughput(run_window, envs, steps, label):
    """env-steps/s over 3 windows: ``run_window()`` enqueues ``steps``
    steps and returns a device tensor of reward sums, which the window
    fetches to the host and checks finite.  Also the host's enqueue time
    per step, before the fetch waits for the device."""
    rates, enqueue_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = run_window()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        rs_host = rs.cpu()
        dt = time.perf_counter() - t0
        require(bool(torch.isfinite(rs_host).all()), f"{label}: non-finite reward sums in a timed window")
        rates.append(envs * steps / dt)
    rate = statistics.median(rates)
    print(f"env-steps/s {label}: median {rate:.1f} "
          f"(windows of {steps} steps: {', '.join(f'{r:.1f}' for r in rates)})")
    print(f"host enqueue ms/step {label}: median {statistics.median(enqueue_ms):.4f} "
          f"(step wall {envs / rate * 1e3:.4f} ms)")
    return rate


def injected_state(n, B, seed):
    """A formation_hd state made with numpy (landmarks on the agents'
    centroid), for the card-against-CPU checks."""
    srng = np.random.RandomState(seed)
    apos = srng.uniform(-1, 1, (B, n, 2))
    ishape = srng.uniform(-1, 1, (B, n, 2))
    ishape -= ishape.mean(1, keepdims=True)
    return dict(
        pos=np.concatenate([apos, ishape + apos.mean(1, keepdims=True)], 1),
        vel=np.zeros((B, 2 * n, 2)), c=np.zeros((B, n, 2)), ideal_shape=ishape,
        ideal_vel=srng.uniform(-1, 1, (B, 2)), t=np.zeros(B, np.int32),
    )


def random_networks(n, seed, dev, log_std=-0.5):
    """A GaussianActor and ValueCritic for n agents, orthogonal init from a
    seed, with head gains raised so that the actions and values vary."""
    from gym_formation_tpu_torch.models.networks import GaussianActor, ValueCritic

    g = torch.Generator()
    g.manual_seed(seed)
    actor = GaussianActor(6 * n, 2, (64, 64), generator=g)
    critic = ValueCritic(6 * n * n, (64, 64), generator=g)
    with torch.no_grad():
        actor.head.weight.mul_(50.0)
        actor.log_std.fill_(log_std)
    return actor.to(dev), critic.to(dev)


def k5_check(dev, rng, n, B):
    """K5 against its plain version at n agents and B envs, T=25, every env
    crossing a reset.  Returns (max abs err, a kernel call, a plain call on
    the same inputs, the kernel's trajectory, (actor, critic))."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
    from gym_formation_tpu_torch.ops.kernels import fused_rollout as k4

    T, ep_len = 25, 10
    v = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, device=dev, seed=5)
    soa = k4.state_to_soa(v.reset_state())
    soa = soa._replace(t=torch.as_tensor(rng.randint(0, ep_len, (1, B)), dtype=torch.int32, device=dev))
    actor, critic = random_networks(n, 7, dev)
    aops, cops = k5.actor_planes(actor), k5.critic_planes(critic)
    kw = dict(length=T, ep_len=ep_len, n=n)
    s_k, tr_k = k5.fused_collect_hd(soa, aops, cops, 9, **kw)
    s_p, tr_p = k5.fused_collect_hd_plain(soa, aops, cops, 9, **kw)
    torch.cuda.synchronize()
    # tolerances: state as K4's (1e-5); trajectory atol 1e-4, rtol 1e-5;
    # done and the episode counters exact
    err = 0.0
    for name in ("ap", "av", "ishape", "ivel"):
        err = max(err, check_close(getattr(s_k, name), getattr(s_p, name), 1e-5, 0.0, f"K5 n={n} {name}"))
    for name in ("obs", "action", "logp", "value", "reward"):
        err = max(err, check_close(tr_k[name], tr_p[name], 1e-4, 1e-5, f"K5 n={n} {name}"))
        require(bool(torch.isfinite(tr_k[name]).all()), f"K5 n={n} {name}: non-finite")
    require(torch.equal(s_k.t, s_p.t), f"K5 n={n}: episode counters differ")
    require(torch.equal(tr_k["done"], tr_p["done"]), f"K5 n={n}: done flags differ")
    require(bool(tr_k["done"].any(0).all()), f"K5 n={n}: not every env reset")
    E, smem = k5.launch_plan(n)
    print(f"K5 n={n} B={B} T={T} ep_len={ep_len} (tiles of {E} envs, {smem} bytes of shared memory, "
          f"{k5._blocks_per_sm(n, torch.cuda.current_device())} blocks an SM): max abs err {err:.3e} "
          f"(state atol 1e-5; trajectory atol 1e-4 rtol 1e-5), done and counters equal, every env reset")
    run = lambda: k5.fused_collect_hd(soa, aops, cops, 9, **kw)
    plain = lambda: k5.fused_collect_hd_plain(soa, aops, cops, 9, **kw)
    return err, run, plain, tr_k, (actor, critic)


def phase_k5(dev, rng):
    """K5 against its plain version at the N=3 training shape and at n=9 over
    several persistent waves (B=4096: 1024 tiles of 4 envs), every env
    crossing a reset; and at n=3 the stored logp and value against the
    networks re-applied to the stored obs and actions."""
    from gym_formation_tpu_torch.models.networks import gaussian_logp

    n, B, T = 3, NUM_ENVS, 25
    err, run, plain, tr_k, (actor, critic) = k5_check(dev, rng, n, B)
    # network parity: tolerances of tests/test_fused_collect.py
    obs = tr_k["obs"].reshape(T * B, n, 6 * n)
    with torch.no_grad():
        v_ref = critic(obs.reshape(T * B, -1))
        lp_ref = gaussian_logp(*actor(obs), tr_k["action"].reshape(T * B, n, 2))
    check_close(tr_k["value"].reshape(-1), v_ref, 1e-4, 1e-4, "K5 value vs critic")
    check_close(tr_k["logp"].reshape(T * B, n), lp_ref, 1e-4, 1e-4, "K5 logp vs actor")
    print("K5 n=3: logp and value match the networks re-applied")
    ms, plain_ms = time_pair(run, plain, plain_reps=1)
    err9, run9, plain9, *_ = k5_check(dev, np.random.RandomState(9), 9, B)
    ms9, plain9_ms = time_pair(run9, plain9, plain_reps=1)
    print(f"K5 n=9 B={B} T={T}: kernel {ms9:.4f} ms, plain {plain9_ms:.4f} ms")
    print(f"K5 n={n} B={B} T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(err=max(err, err9), ms=ms, plain_ms=plain_ms)


def mappo_n3(dev, num_envs, **cfg):
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig

    return MAPPO(gt.make_env("formation_hd_env", num_agents=3), MAPPOConfig(**cfg),
                 num_envs=num_envs, device=dev)


def phase_k9(dev):
    """K9 against its plain version, and the fused epoch gradient against
    autograd of the loss, on a real K5 trajectory after _prepare."""
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9

    algo = mappo_n3(dev, NUM_ENVS, fused_update=True)
    require(algo.fused_collect, "MAPPO N=3 on the card: fused_collect did not come on")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    ts, es, obs = algo.init(g)
    with torch.no_grad():
        es, obs, traj, _, last_value = algo._collect_fused(ts, es, obs, g)
    ts, data = algo._prepare(ts, traj, last_value)
    M = data["obs"].shape[0]
    f = lambda t: t.detach().float().contiguous()
    (a1, a2), (c1, c2) = ts.actor.mlp.layers, ts.critic.mlp.layers
    aops = (f(a1.weight.T), f(a1.bias), f(a2.weight.T), f(a2.bias), f(ts.actor.head.weight.T),
            f(ts.actor.head.bias), f(ts.actor.bounded_log_std()))
    cops = (f(c1.weight.T), f(c1.bias), f(c2.weight.T), f(c2.bias), f(ts.critic.head.weight.T),
            f(ts.critic.head.bias))
    sub = {k: data[k] for k in ("obs", "action", "logp", "adv", "value", "target")}
    kw = dict(n_agents=3, act_dim=2, clip_eps=algo.cfg.clip_eps, huber_delta=algo.cfg.huber_delta,
              value_coef=algo.cfg.value_coef)
    got = k9.fused_ppo_grads(sub, aops, cops, **kw)
    want = k9.fused_ppo_grads_plain(sub, aops, cops, **kw)
    torch.cuda.synchronize()
    # tolerance of tests/test_fused_ppo_grad.py: rtol 2e-3, atol 2e-6 a
    # gradient leaf; the metric sums as the means the learner reports
    # (pg_loss, v_loss, approx_kl), to atol 1e-6 rtol 2e-3
    err = 0.0
    for i, (x, y) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        err = max(err, check_close(x, y, 2e-6, 2e-3, f"K9 gradient leaf {i}"))
    per_row = torch.tensor([3 * M, M, 3 * M], dtype=torch.float32, device=dev)
    check_close(got[2] / per_row, want[2] / per_row, 1e-6, 2e-3, "K9 metrics")
    again = k9.fused_ppo_grads(sub, aops, cops, **kw)
    require(all(torch.equal(x, y) for x, y in zip(got[0] + got[1], again[0] + again[1])),
            "K9: two runs differ")
    grads, _ = algo._fused_epoch_grads(ts, data)
    total, _ = algo._loss(ts, data, ts.value_norm)
    ref = torch.autograd.grad(total, ts.params())
    for (name, _), x, y in zip(list(ts.actor.named_parameters()) + list(ts.critic.named_parameters()),
                               grads, ref):
        check_close(x, y, 2e-6, 2e-3, f"K9 epoch gradient vs autograd: {name}")
    ms, plain_ms = time_pair(lambda: k9.fused_ppo_grads(sub, aops, cops, **kw),
                             lambda: k9.fused_ppo_grads_plain(sub, aops, cops, **kw))
    print(f"K9 M={M} (actor rows {3 * M}): max abs err {err:.3e} vs plain (rtol 2e-3, atol 2e-6 "
          f"a leaf), deterministic; the epoch gradient matches autograd of the loss")
    print(f"K9 M={M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(err=err, ms=ms, plain_ms=plain_ms, M=M)


def train_iterations(algo, ts, es, obs, g, iters, label):
    """``iters`` train_step calls, each closed by a host fetch of the
    metrics and a finiteness check.  Returns the state and the walls."""
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, es, obs, m = algo.train_step(ts, es, obs, g)
        host = {k: float(v) for k, v in m.items()}
        walls.append(time.perf_counter() - t0)
        require(all(np.isfinite(v) for v in host.values()), f"{label}: non-finite metrics {host}")
    return ts, es, obs, host, walls


def split_iteration(algo, ts, es, obs, g):
    """One iteration as train_step runs it, with CUDA events between
    collect, prepare and update.  Returns ms of each and the state."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    collect = (algo._collect_structured if algo.structured_obs else
               algo._collect_fused if algo.fused_collect else algo._collect)
    update = algo._update_fused if algo.cfg.fused_update else algo._update
    torch.cuda.synchronize()
    ev[0].record()
    with torch.no_grad():
        es, obs, traj, _, last_value = collect(ts, es, obs, g)
    ev[1].record()
    ts, data = algo._prepare(ts, traj, last_value)
    ev[2].record()
    ts, m = update(ts, data, g)
    ev[3].record()
    torch.cuda.synchronize()
    require(all(np.isfinite(float(v)) for v in m.values()), "split iteration: non-finite metrics")
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    return dict(collect=ms[0], prepare=ms[1], update=ms[2]), ts, es, obs


def fmt_split(s):
    return ", ".join(f"{k} {v:.3f} ms" for k, v in s.items())


def launch_counts(mods):
    return {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}


TIMED_ITERS = 3


def phase_mappo_n3(dev, kmods):
    """The MAPPO N=3 path: fused collection (K5) and fused update (K9), by
    the auto gate, through train_step."""
    import gym_formation_tpu_torch as gt

    algo = mappo_n3(dev, NUM_ENVS, fused_update=True)
    require(algo.fused_collect, "MAPPO N=3 on the card: the auto gate did not turn fused_collect on")
    T, epochs = algo.cfg.rollout_len, algo.cfg.ppo_epochs
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ts, es, obs = algo.init(g)
    ts, es, obs, _, _ = train_iterations(algo, ts, es, obs, g, 1, "MAPPO N=3 warm-up")
    reset_counts(*kmods)
    ts, es, obs, m, walls = train_iterations(algo, ts, es, obs, g, TIMED_ITERS, "MAPPO N=3")
    counts = launch_counts(kmods)
    print(f"MAPPO N=3 B={NUM_ENVS} fused: launches in {TIMED_ITERS} iterations {counts}")
    require(counts["fused_collect"] == TIMED_ITERS, "MAPPO N=3: K5 not once an iteration")
    require(counts["fused_ppo_grad"] == TIMED_ITERS * epochs, "MAPPO N=3: K9 not once an epoch")
    for name in ("pairforce_sym", "reward_sym", "fused_step", "fused_rollout", "pairforce", "reward",
                 "pairforce_cull"):
        require(counts[name] == 0, f"MAPPO N=3: {name} launched")
    wall = statistics.median(walls)
    rate = T * NUM_ENVS / wall
    print(f"training env-steps/s MAPPO N=3 B={NUM_ENVS} fused collect + fused update: {rate:.1f} "
          f"(iteration walls {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms)")
    split, ts, es, obs = split_iteration(algo, ts, es, obs, g)
    print(f"MAPPO N=3 fused iteration: {fmt_split(split)}")

    auto = mappo_n3(dev, NUM_ENVS)
    ts_a, es_a, obs_a = auto.init(g)
    ts_a, es_a, obs_a, _, _ = train_iterations(auto, ts_a, es_a, obs_a, g, 1, "MAPPO N=3 autograd warm-up")
    ts_a, es_a, obs_a, _, walls_a = train_iterations(auto, ts_a, es_a, obs_a, g, TIMED_ITERS, "MAPPO N=3 autograd")
    rate_a = T * NUM_ENVS / statistics.median(walls_a)
    split_a, *_ = split_iteration(auto, ts_a, es_a, obs_a, g)
    print(f"training env-steps/s MAPPO N=3 B={NUM_ENVS} fused collect + autograd update: {rate_a:.1f}; "
          f"iteration: {fmt_split(split_a)}")

    # the card against the CPU's plain versions on one iteration, from the
    # same networks, env state and K5 seed; tolerances of the slice test
    small = {}
    st = injected_state(3, 64, 21)
    for d in ("cuda", "cpu"):
        a = mappo_n3(torch.device(d), 64, rollout_len=8, fused_collect=True, fused_update=True)
        actor, critic = random_networks(3, 3, torch.device(d))
        t_s = a.init_state(actor, critic)
        a._next_seed = lambda: 12345
        gd = torch.Generator(device=d)
        t_s, _, _, mm = a.train_step(t_s, gt.state_from_numpy(st, device=d), None, gd)
        small[d] = (t_s.params(), float(mm["v_loss"]))
    for i, (x, y) in enumerate(zip(small["cuda"][0], small["cpu"][0])):
        check_close(x.detach().cpu(), y.detach(), 5e-5, 5e-3, f"MAPPO N=3 card vs CPU param {i}")
    require(abs(small["cuda"][1] - small["cpu"][1]) <= 1e-3 * abs(small["cpu"][1]),
            f"MAPPO N=3 card vs CPU v_loss {small['cuda'][1]} vs {small['cpu'][1]}")
    print(f"MAPPO N=3 B=64 T=8 one iteration: card and CPU plain agree (params rtol 5e-3 atol 5e-5, "
          f"v_loss {small['cuda'][1]:.6f} vs {small['cpu'][1]:.6f})")

    # learns: the loose band of tests/test_fused_collect.py over 12 iterations
    learn = mappo_n3(dev, NUM_ENVS, fused_update=True)
    gl = torch.Generator(device=dev)
    gl.manual_seed(1)
    ts_l, es_l, obs_l = learn.init(gl)
    rewards = []
    for _ in range(12):
        ts_l, es_l, obs_l, m_l = learn.train_step(ts_l, es_l, obs_l, gl)
        rewards.append(float(m_l["mean_step_reward"]))
    require(all(np.isfinite(rewards)) and rewards[-1] > rewards[0] - 2.0,
            f"MAPPO N=3: mean_step_reward left the band: {rewards}")
    print(f"MAPPO N=3 12 iterations: mean_step_reward {rewards[0]:.4f} -> {rewards[-1]:.4f}")
    return dict(counts=counts, rate=rate)


def phase_mappo_n243(dev, kmods):
    """The MAPPO N=243 structured path at B=1024: K1 and K2 in every env
    step, no observation built, no K5 or K9."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig

    B = 1024
    env = gt.make_env("formation_hd_env", num_agents=NUM_AGENTS)
    algo = MAPPO(env, MAPPOConfig(), num_envs=B, device=dev)
    require(algo.structured_obs and not algo.fused_collect,
            "MAPPO N=243: the auto gate did not choose the structured path")
    T = algo.cfg.rollout_len
    observed = [0]
    observe = env.scenario.observe

    def counting_observe(state):
        observed[0] += 1
        return observe(state)

    env.scenario.observe = counting_observe
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ts, es, obs = algo.init(g)
    torch.cuda.reset_peak_memory_stats()
    ts, es, obs, _, _ = train_iterations(algo, ts, es, obs, g, 1, "MAPPO N=243 warm-up")
    reset_counts(*kmods)
    observed[0] = 0
    ts, es, obs, m, walls = train_iterations(algo, ts, es, obs, g, TIMED_ITERS, "MAPPO N=243")
    counts = launch_counts(kmods)
    print(f"MAPPO N=243 B={B} structured: launches in {TIMED_ITERS} iterations {counts}, "
          f"observe calls {observed[0]}")
    for name in ("pairforce_sym", "reward_sym"):
        require(counts[name] == TIMED_ITERS * T, f"MAPPO N=243: {name} not once an env step")
    for name in ("fused_collect", "fused_ppo_grad", "fused_step", "fused_rollout", "pairforce", "reward",
                 "pairforce_cull"):
        require(counts[name] == 0, f"MAPPO N=243: {name} launched")
    require(observed[0] == 0, "MAPPO N=243: the structured collection built observations")
    wall = statistics.median(walls)
    rate = T * B / wall
    print(f"training env-steps/s MAPPO N=243 B={B} structured: {rate:.1f}, agent-steps/s "
          f"{rate * NUM_AGENTS:.1f} (iteration walls {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms)")
    split, ts, es, obs = split_iteration(algo, ts, es, obs, g)
    print(f"MAPPO N=243 structured iteration: {fmt_split(split)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mean_step_reward "
          f"{m['mean_step_reward']:.4f}")
    env.scenario.observe = observe

    bf = MAPPO(env, MAPPOConfig(structured_bf16=True), num_envs=B, device=dev)
    ts, es, obs, m16, walls16 = train_iterations(bf, ts, es, obs, g, 1, "MAPPO N=243 bf16")
    print(f"MAPPO N=243 B={B} structured_bf16: one iteration {walls16[0] * 1e3:.3f} ms, finite metrics "
          f"(v_loss {m16['v_loss']:.4f})")
    return dict(counts=counts, rate=rate)


# -- bounds -------------------------------------------------------------------
# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the device
# memory rate and its FP32 operations over the FP32 rate outside the tensor
# cores (H100 SXM data sheet, at the full 700 W; the card's own limit is
# printed beside).  The special-function units (16 results a clock per SM)
# give a second operations bound for the transcendental-heavy pair kernels,
# printed beside their times.  Work is counted as the function needs it,
# not as a kernel happens to do it: what the two directions of a pair share
# is counted once per unordered pair.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# FP32 operations of one soft-contact pair (a transcendental counted as one
# operation: a lower bound).  Shared by its two directions: the differences
# 2, the squared distance 3, the root 1, z 3, |z| 1, exp 1, log1p 1, max and
# add 2, the times k 1, the coefficient 3.  Each direction: its two
# multiply-adds 4.  The subsets timed here have equal masses, so the pair
# factor m_j/m_i is 1 and costs nothing.
PAIR_SHARED_OPS, PAIR_DIR_OPS = 18, 4
# special-function results of one unordered pair: rsqrt (it gives 1/d, and
# d = s·rsqrt(s)), exp, log.  1/k and 1/m are per cfg and per entity.
PAIR_SFU = 3
# reward statistics: per (agent, vertex) the squared distance 5 and two
# minima 2; per unordered agent pair the squared distance 5 and the compare
# 1; per direction the count 1
HAUS_OPS, COLL_SHARED_OPS, COLL_DIR_OPS = 7, 6, 1
STEP_OPS = 20  # integration per agent: damping, force / mass, clamp, update


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mlp_flops(dims):
    """Multiply-add FLOPs of one row through dense layers of widths ``dims``."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def pair_ops(ordered):
    """FP32 operations of the contact terms of ``ordered`` ordered pairs
    (both directions of every pair among them)."""
    return ordered / 2 * PAIR_SHARED_OPS + ordered * PAIR_DIR_OPS


def stat_ops(n):
    """FP32 operations of one env's reward statistics at n agents."""
    return n * n * HAUS_OPS + n * (n - 1) / 2 * COLL_SHARED_OPS + n * (n - 1) * COLL_DIR_OPS


# ezpolicy (K4): per (agent, vertex) the differences 2, the squared distance
# 3, the root 1 and the column's compare 1; per agent the far vertex n, the
# pick 2n (the mask and the compare), the target n, the settled test 6n (the
# differences, squares and sum over the shape, the compare), the action 8
# and the force 6; per env the centroid 4n
def policy_ops(n):
    """FP32 operations of one env's ezpolicy at n agents."""
    return n * n * 7 + n * (10 * n + 14) + 4 * n


# the in-kernel BFS + ezpolicy of K3 (``bfs_planes.bfs_ez_planes``) at n =
# 3^L: per pyramid row (levels 0 .. L-1, (n - 1) / 2 rows) the four centroids
# 12 (two adds and a division each); per group of three members (as many
# groups as pyramid rows) the members centred 12 and the nine squared
# distances 45, and per member the far vertex 3, the claims 6, the masked
# distances 3, the pick 3, the target 4 (selects), the settled test 17, the
# scale 2, the clamped step 8 and the commanded velocity 6 (52); per agent
# the action into the force 4
BFS_ROW_OPS, BFS_GROUP_OPS, BFS_MEMBER_OPS, BFS_FORCE_OPS = 12, 12 + 45, 52, 4


def bfs_policy_ops(n):
    """FP32 operations of one env's BFS + ezpolicy in K3 at n = 3^L agents."""
    rows = (n - 1) // 2
    return rows * (BFS_ROW_OPS + BFS_GROUP_OPS + 3 * BFS_MEMBER_OPS) + n * BFS_FORCE_OPS


def env_step_ops(n):
    """FP32 operations of one env step after the actions at n agents: the
    contact pairs, the reward statistics and the integration."""
    return pair_ops(n * (n - 1)) + stat_ops(n) + n * STEP_OPS


def k4_floors(B, T, n):
    """K4's least times for B envs and T steps at n agents, in ms: the bound
    (FP32 operations as the function needs them, at the rate that counts a
    multiply-add as two), the no-FMA floor (each operation one FP32
    instruction, every multiply and add rounded on its own) and the
    special-function floor (the policy's n^2 roots, 3 results an unordered
    pair, the reward's two roots)."""
    ops = B * T * (env_step_ops(n) + policy_ops(n))
    ms, by = bound(B * 8 * (6 * n + 3) + 4 * B, ops)
    sfu = B * T * (n * n + 3 * n * (n - 1) / 2 + 2) / SFU_OPS_PER_S * 1e3
    return dict(bound=ms, bound_by=by, nofma=ops / (FP32_OPS_PER_S / 2) * 1e3, sfu=sfu)


def sfu_ms(ordered):
    """Special-function bound of the contact terms of ``ordered`` ordered pairs."""
    return ordered / 2 * PAIR_SFU / SFU_OPS_PER_S * 1e3


def near_pairs(pos, cut):
    """Ordered pairs i != j of each env closer than ``cut``: the pairs whose
    contact term can be non-zero, the work K8's function needs."""
    total = 0
    for chunk in pos.split(256):
        d = chunk[:, :, None, :] - chunk[:, None, :, :]
        total += int(((d * d).sum(-1) < cut * cut).sum()) - chunk.shape[0] * chunk.shape[1]
    return total


def take(state, sl):
    """The envs ``sl`` of a batched state."""
    import dataclasses

    return type(state)(*(getattr(state, f.name)[sl] for f in dataclasses.fields(state)))


def hd_obs_cfgs(n):
    """(scenario, colliding-subset cfg, subset indices) of formation_hd_obs_env."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core.physics import _collide_subset

    scen = gt.make_scenario("formation_hd_obs_env", num_agents=n)
    _, _, idx, sub = _collide_subset(scen.cfg)
    return scen, sub, idx


def het_cfg():
    """tests/test_pallas.py:70-77: mass 2.5, an immovable block and a
    non-colliding block among 256 entities of two sizes."""
    from gym_formation_tpu_torch.core import make_world_cfg

    cfg = make_world_cfg(100, 156, agent_size=0.05, landmark_size=0.04,
                         landmark_collide=True, landmark_movable=True)
    cfg.collide[120:180] = False
    cfg.movable[200:] = False
    cfg.mass[50:100] = 2.5
    return cfg


def phase_k6(dev, rng):
    """K6 against its plain version: the hd_obs colliding subset at N=243
    (E=246) at B=512 and 4096, the heterogeneous fixture, and exact contact
    and zero distance."""
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6

    _, obs_cfg, _ = hd_obs_cfgs(NUM_AGENTS)
    E = obs_cfg.n_entities
    contact = rng.uniform(-1, 1, (5, E, 2)).astype(np.float32)
    contact[:, 1] = contact[:, 0] + np.float32([0.2, 0.0])  # agents: 0.1 + 0.1
    contact[:, E - 1] = contact[:, 0] + np.float32([0.0, 0.25])  # agent and obstacle: 0.1 + 0.15
    contact[:, 3] = contact[:, 4]  # zero distance
    fixtures = (("hd_obs subset", obs_cfg, rng.uniform(-1, 1, (512, E, 2))),
                ("hd_obs subset", obs_cfg, rng.uniform(-1, 1, (NUM_ENVS, E, 2))),
                ("heterogeneous", het_cfg(), rng.uniform(-0.4, 0.4, (512, 256, 2))),
                ("contact", obs_cfg, contact))
    err = 0.0
    for label, cfg, pos in fixtures:
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        got = k6.collision_forces_batched(pos, cfg)
        want = k6.collision_forces_batched_plain(pos, cfg)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"K6 {label}: non-finite forces")
        err = max(err, check_close(got, want, 1e-3, 1e-3, f"K6 {label} B={pos.shape[0]}"))
        print(f"K6 {label} B={pos.shape[0]} E={pos.shape[1]}: max abs err {max_err(got, want):.3e} "
              f"(atol=rtol=1e-3)")
    return err


def phase_k7(dev, rng):
    """K7 against its plain version and against K2 on K2's phase-4
    fixtures."""
    from gym_formation_tpu_torch.ops.kernels import reward as k7
    from gym_formation_tpu_torch.ops.kernels import reward_sym as k2

    err = 0.0
    for B, scale in ((512, 1.0), (512, 0.05), (NUM_ENVS, 0.05)):
        apos = torch.as_tensor(rng.uniform(-1, 1, (B, NUM_AGENTS, 2)) * scale, dtype=torch.float32, device=dev)
        ishape = torch.as_tensor(rng.uniform(-1, 1, (B, NUM_AGENTS, 2)), dtype=torch.float32, device=dev)
        ishape = (ishape - ishape.mean(1, keepdim=True)).contiguous()
        h, nc = k7.hd_reward_stats_batched(apos, ishape, thresh=THRESH)
        h_p, nc_p = k7.hd_reward_stats_batched_plain(apos, ishape, thresh=THRESH)
        h2, nc2 = k2.hd_reward_stats_sym(apos, ishape, thresh=THRESH)
        torch.cuda.synchronize()
        err = max(err, check_close(h, h_p, 1e-5, 0.0, f"K7 haus B={B} scale={scale}"))
        require(torch.equal(nc, nc_p), f"K7 counts B={B} scale={scale}: kernel and plain differ")
        check_close(h, h2, 1e-6, 0.0, f"K7 against K2 haus B={B} scale={scale}")
        require(torch.equal(nc, nc2), f"K7 against K2 counts B={B} scale={scale} differ")
        if scale < 1.0:
            require(int(nc.sum()) > 0, "K7: the squeezed fixture has no collisions")
        print(f"K7 B={B} N={NUM_AGENTS} scale={scale}: haus max abs err {max_err(h, h_p):.3e} (atol 1e-5), "
              f"against K2 {max_err(h, h2):.3e} (atol 1e-6); counts equal to plain and K2 "
              f"({int(nc.sum())} collisions)")
    return err


def k8_report(pos, cfg, label):
    """K8's evaluated pairs on ``pos`` against the near pairs (the function's
    need) and against all E(E-1) ordered pairs, and the wrapper's time (one
    launch).  Returns (evaluated pairs, near pairs, wrapper ms)."""
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    B, E = pos.shape[:2]
    pairs = torch.zeros(B, dtype=torch.int32, device=pos.device)
    k8.collision_forces_culled(pos, cfg, pairs=pairs)
    cand = int(pairs.long().sum())
    near = near_pairs(pos, k8.cutoff(cfg))
    wrap_ms = time_ms(lambda: k8.collision_forces_culled(pos, cfg), 20)
    print(f"K8 {label} B={B} E={E}: {cand} pairs evaluated ({cand / (B * E):.2f} a receiver), "
          f"{cand / max(near, 1):.3f}x the {near} near pairs, {cand / (B * E * (E - 1)):.4f} of E(E-1); "
          f"wrapper {wrap_ms:.4f} ms")
    return cand, near, wrap_ms


def phase_k8(dev, rng):
    """K8 against its plain version and against K6 at E=243 (the hd subset)
    and E=246 (the hd_obs subset), B=4096, on dense and spread positions;
    its count of evaluated pairs against the plain grid's candidates."""
    from gym_formation_tpu_torch.core import make_world_cfg
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8

    _, obs_cfg, _ = hd_obs_cfgs(NUM_AGENTS)
    hd_cfg = make_world_cfg(NUM_AGENTS, 0, agent_size=0.03)
    err = 0.0
    for label, cfg in (("hd subset", hd_cfg), ("hd_obs subset", obs_cfg)):
        for spread in (0.5, 3.0):
            E = cfg.n_entities
            pos = torch.as_tensor(rng.uniform(-spread, spread, (NUM_ENVS, E, 2)), dtype=torch.float32, device=dev)
            pairs = torch.zeros(NUM_ENVS, dtype=torch.int32, device=dev)
            got = k8.collision_forces_culled(pos, cfg, pairs=pairs)
            want = k8.collision_forces_culled_plain(pos, cfg)
            dense = k6.collision_forces_batched(pos, cfg)
            torch.cuda.synchronize()
            what = f"K8 {label} spread {spread}"
            require(bool(torch.isfinite(got).all()), f"{what}: non-finite forces")
            err = max(err, check_close(got, want, 1e-3, 1e-3, what + " against plain"))
            check_close(got, dense, 2e-4, 1e-4, what + " against K6")
            require(torch.equal(pairs.long(), k8.candidate_pairs_plain(pos, cfg)),
                    f"{what}: evaluated pairs differ from the plain grid's candidates")
            print(f"{what}: max abs err {max_err(got, want):.3e} against plain (atol=rtol=1e-3), "
                  f"{max_err(got, dense):.3e} against K6 (atol 2e-4, rtol 1e-4); evaluated pairs equal "
                  f"the plain grid's")
            cand, near, _ = k8_report(pos, cfg, f"{label} spread {spread}")
            require(cand >= near, f"{what}: fewer pairs evaluated than lie within the cutoff")
    return err


def hd_obs_small_check(dev):
    """formation_hd_obs_env on a small injected state (N=27, B=3, T=8,
    within an episode) under the linear policy: the card (K6) against the
    CPU's plain path, at the step slice's tolerances."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch import bench

    n, B, T = 27, 3, 8
    env = gt.make_env("formation_hd_obs_env", num_agents=n)
    r = np.random.RandomState(3)
    E = env.cfg.n_entities
    pos = r.uniform(-0.5, 0.5, (B, E, 2))
    pos[:, n + 4 :] = pos[:, :3] + 0.1  # obstacles among the agents
    st = dict(pos=pos, vel=np.zeros((B, E, 2)), c=np.zeros((B, n, 2)), ideal_shape=np.zeros((B, 7, 2)),
              ideal_vel=np.zeros((B, 2)), t=np.zeros(B, np.int32))
    out = {}
    for d in ("cuda", "cpu"):
        policy = bench.make_policy("linear", env, d, W=bench.linear_weights(env.scenario.obs_dim, env.act_dim, d,
                                                                           seed=3))
        g = torch.Generator(device=d)
        s = env.scenario.pre_obs(gt.state_from_numpy(st, device=d))
        obs = env.scenario.observe(s)
        rews = []
        for _ in range(T):
            s, o = env.step(s, policy(obs, g), g)
            obs = o.obs
            rews.append(o.reward)
        out[d] = (s.pos.cpu(), s.vel.cpu(), torch.stack(rews).cpu())
    (cp, cv, cr), (pp, pv, pr) = out["cuda"], out["cpu"]
    check_close(cp, pp, 2e-4, 1e-4, "hd_obs slice pos")
    check_close(cv, pv, 2e-3, 1e-4, "hd_obs slice vel")
    check_close(cr, pr, 1e-4, 1e-5, "hd_obs slice reward")
    require(float(pr.min()) < -2.0, "hd_obs slice: no collisions")
    print(f"hd_obs slice N={n} B={B} T={T}: card vs CPU plain agree (pos {max_err(cp, pp):.2e}, "
          f"vel {max_err(cv, pv):.2e}, reward {max_err(cr, pr):.2e})")


def phase_hd_obs(dev, kmods):
    """The hd_obs path: formation_hd_obs_env at N=243, B=4096 (4 targets, 3
    obstacles), 128 steps of the linear policy with world_length 50."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch import bench
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6

    venv = gt.make_vec_env("formation_hd_obs_env", num_envs=NUM_ENVS, num_agents=NUM_AGENTS,
                           device=dev, seed=0, world_length=50)
    scen = venv.env.scenario
    policy = bench.make_policy("linear", venv.env, dev)
    state, obs = venv.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kmods)
    t0 = time.perf_counter()
    state, obs, rsum = bench.obs_chunk(venv.env, state, obs, venv.generator, STEPS, policy)
    rsum_host = rsum.cpu()
    first_run_s = time.perf_counter() - t0
    counts = launch_counts(kmods)
    print(f"{STEPS} hd_obs steps at N={NUM_AGENTS} B={NUM_ENVS} (obs {scen.obs_dim} wide): "
          f"{first_run_s:.2f} s, launches {counts}")
    require(counts["pairforce"] == STEPS, f"hd_obs: K6 launched {counts['pairforce']} times in {STEPS} steps")
    require(counts["pairforce_sym"] == 0, "hd_obs: K1 launched")
    require(bool(torch.isfinite(rsum_host).all()), "hd_obs: non-finite reward sums")
    require(bool(torch.isfinite(state.pos).all()), "hd_obs: non-finite state")
    t_ep = STEPS % venv.env.world_length
    require(bool(torch.all(state.t.cpu() == t_ep)), "hd_obs: episode counters after the auto-resets")
    oy = state.pos[:, NUM_AGENTS + scen.num_targets:, 1]
    require(float(oy.mean()) < 1.5, f"hd_obs: the obstacles did not fall (mean y {float(oy.mean()):.3f})")
    print(f"hd_obs reward sum per env: mean {float(rsum_host.mean()):.4f}; obstacles {t_ep} steps into "
          f"their episode: mean y {float(oy.mean()):.4f} (spawned in [2.0, 2.5]), "
          f"{float((oy > 2.0).float().mean()):.4f} still above 2.0")
    hd_obs_small_check(dev)

    def window():
        nonlocal state, obs
        state, obs, rs = bench.obs_chunk(venv.env, state, obs, venv.generator, WINDOW, policy)
        return rs

    rate = throughput(window, NUM_ENVS, WINDOW, f"hd_obs path N={NUM_AGENTS} B={NUM_ENVS}")
    print(f"hd_obs peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # K6 against its plain version at the path's shapes
    _, sub, idx = hd_obs_cfgs(NUM_AGENTS)
    pos = state.pos[:, torch.as_tensor(idx, device=dev)].contiguous()
    ms, plain_ms = time_pair(lambda: k6.collision_forces_batched(pos, sub),
                             lambda: k6.collision_forces_batched_plain(pos, sub))
    pairs = NUM_ENVS * pos.shape[1] * (pos.shape[1] - 1)
    print(f"K6 B={NUM_ENVS} E={pos.shape[1]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"special-function bound {sfu_ms(pairs):.4f} ms")

    small = gt.make_vec_env("formation_hd_obs_env", num_envs=NUM_ENVS, num_agents=27, device=dev, seed=1)
    s27, o27 = small.reset()
    p27 = bench.make_policy("linear", small.env, dev)

    def window27():
        nonlocal s27, o27
        s27, o27, rs = bench.obs_chunk(small.env, s27, o27, small.generator, WINDOW, p27)
        return rs

    throughput(window27, NUM_ENVS, WINDOW, f"hd_obs path N=27 B={NUM_ENVS}")
    return dict(counts=counts, rate=rate, ms=ms, plain_ms=plain_ms, E=pos.shape[1])


SELECTOR_STEPS = 32
COMPARE_ENVS, COMPARE_STEPS = 16, 8


def phase_selectors(dev, kmods):
    """The step path (formation_hd_env, N=243, B=4096, BFS + ezpolicy) under
    set_pallas_impl("cull"), set_pallas_impl("dense") and
    set_reward_impl("rowmajor").  Each run's per-step rewards are held
    against the default selectors' from the same states: the first 8 steps
    of 16 envs, each step started from the default run's state, so that the
    comparison sees one step's rounding and no trajectory divergence."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core import set_pallas_impl, set_reward_impl
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8
    from gym_formation_tpu_torch.ops.kernels import reward as k7

    venv = gt.make_vec_env("formation_hd_env", num_envs=NUM_ENVS, num_agents=NUM_AGENTS, device=dev, seed=0)
    scen = venv.env.scenario
    policy = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, scen, s, 3)
    start = venv.reset_state()
    g = torch.Generator(device=dev)
    ref_states, ref_rews = [take(start, slice(0, COMPARE_ENVS))], []
    for _ in range(COMPARE_STEPS):
        st, rew = gt.rollout_statepolicy(venv.env, policy, ref_states[-1], g, 1)
        ref_states.append(st)
        ref_rews.append(rew[0])
    runs = (("cull", lambda: set_pallas_impl("cull"), "pairforce_cull", "pairforce_sym"),
            ("dense", lambda: set_pallas_impl("dense"), "pairforce", "pairforce_sym"),
            ("rowmajor", lambda: set_reward_impl("rowmajor"), "reward", "reward_sym"))
    out = {}
    try:
        for label, select, kname, other in runs:
            set_pallas_impl("auto")
            set_reward_impl("auto")
            select()
            err = 0.0
            for t in range(COMPARE_STEPS):
                _, rew = gt.rollout_statepolicy(venv.env, policy, ref_states[t], g, 1)
                err = max(err, check_close(rew[0], ref_rews[t], 1e-4, 1e-5, f"{label} step {t} reward"))
            state = start
            torch.cuda.synchronize()
            reset_counts(*kmods)
            state, rs = gt.rollout_statepolicy_rewardsum(venv.env, policy, state, venv.generator, SELECTOR_STEPS)
            rs_host = rs.cpu()
            counts = launch_counts(kmods)
            print(f"{label}: {SELECTOR_STEPS} steps at N={NUM_AGENTS} B={NUM_ENVS}, launches {counts}; "
                  f"per-step rewards of {COMPARE_ENVS} envs x {COMPARE_STEPS} steps against the default "
                  f"selectors' max abs err {err:.3e} (atol 1e-4, rtol 1e-5)")
            require(counts[kname] == SELECTOR_STEPS, f"{label}: {kname} not once a step")
            require(counts[other] == 0, f"{label}: {other} launched")
            require(bool(torch.isfinite(rs_host).all()), f"{label}: non-finite reward sums")

            def window():
                nonlocal state
                state, r = gt.rollout_statepolicy_rewardsum(venv.env, policy, state, venv.generator, WINDOW)
                return r

            rate = throughput(window, NUM_ENVS, WINDOW, f"step path {label} N={NUM_AGENTS} B={NUM_ENVS}")
            out[label] = dict(counts=counts, rate=rate, state=state)
    finally:
        set_pallas_impl("auto")
        set_reward_impl("auto")

    # K8 and K7 against their plain versions at the paths' shapes
    from gym_formation_tpu_torch.core import make_world_cfg

    cfg = make_world_cfg(NUM_AGENTS, 0, agent_size=0.03)
    pos = scen.agent_pos(out["cull"]["state"]).contiguous()
    cand, near, _ = k8_report(pos, cfg, "cull path state")
    ms8, plain8 = time_pair(lambda: k8.collision_forces_culled(pos, cfg),
                            lambda: k8.collision_forces_culled_plain(pos, cfg))
    print(f"K8 B={NUM_ENVS} cull path: wrapper {ms8:.4f} ms, plain {plain8:.4f} ms; {near} ordered pairs "
          f"within the cutoff ({near / (NUM_ENVS * NUM_AGENTS * (NUM_AGENTS - 1)):.4f} of all); "
          f"special-function bound of those {sfu_ms(near):.4f} ms")
    k6_ms = time_ms(lambda: k6.collision_forces_batched(pos, cfg), 20)
    print(f"K6 on the same positions (E={NUM_AGENTS}): {k6_ms:.4f} ms")
    rpos = scen.agent_pos(out["rowmajor"]["state"]).contiguous()
    rish = out["rowmajor"]["state"].ideal_shape.contiguous()
    ms7, plain7 = time_pair(lambda: k7.hd_reward_stats_batched(rpos, rish, thresh=THRESH),
                            lambda: k7.hd_reward_stats_batched_plain(rpos, rish, thresh=THRESH))
    print(f"K7 B={NUM_ENVS} rowmajor path: kernel {ms7:.4f} ms, plain {plain7:.4f} ms")
    return dict(out=out, k8=dict(ms=ms8, plain_ms=plain8, near=near, pairs=cand),
                k7=dict(ms=ms7, plain_ms=plain7))


def phase_other_scenarios(dev, kmods):
    """The two partial scenarios (N=27, the linear policy) at B=4096: K1
    once a step, finite rewards, env-steps/s.  basic_formation_env, the
    bench's SUITE row 3, is driven and counted in phase 42."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch import bench

    n = 27
    for name in ("formation_hd_partial_env", "formation_hd_partial_range_env"):
        venv = gt.make_vec_env(name, num_envs=NUM_ENVS, num_agents=n, device=dev, seed=0)
        policy = bench.make_policy("linear", venv.env, dev)
        state, obs = venv.reset()
        torch.cuda.synchronize()
        reset_counts(*kmods)
        state, obs, rs = bench.obs_chunk(venv.env, state, obs, venv.generator, WINDOW, policy)
        rs_host = rs.cpu()
        counts = launch_counts(kmods)
        require(counts["pairforce_sym"] == WINDOW, f"{name}: K1 not once a step ({counts})")
        require(bool(torch.isfinite(rs_host).all()), f"{name}: non-finite reward sums")
        print(f"{name} N={n} B={NUM_ENVS} linear: launches in {WINDOW} steps {counts}, "
              f"reward sum per env mean {float(rs_host.mean()):.4f}")

        def window():
            nonlocal state, obs
            state, obs, r = bench.obs_chunk(venv.env, state, obs, venv.generator, WINDOW, policy)
            return r

        throughput(window, NUM_ENVS, WINDOW, f"{name} N={n} B={NUM_ENVS}")

# -- the on-policy family at N=3 ------------------------------------------------
RMAPPO_ENVS, MAPPO_ENVS = 128, 512  # the reference's tuned rmappo run; the discrete MAPPO run
ZOO_ENVS = 32  # the reference's off-policy zoo protocol (RESULTS.md:595-600)
# The on-policy band (12 iterations lose at most 2.0) does not hold for the
# reference's own off-policy learners: before they learn, their reward falls
# with the episodes' progress and the first updates (the JAX package on the
# CPU, tools/offpolicy_early_rewards.py: MADDPG -4.44 -> -55.53 in 12
# iterations).  Their band: every iteration finite and above this floor.
ZOO_FLOOR = -100.0
ONPOLICY_KINDS = ("rmappo", "discrete", "separated")


def onpolicy_algo(kind, dev, num_envs, **cfg):
    """The learner of an on-policy path at N=3: ``rmappo`` (the tuned
    configuration: episodes of 25 steps, GRU 64, chunks of 5), ``discrete``
    (MAPPO with the categorical head) or ``separated`` (MAPPO with per-agent
    networks)."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig, RMAPPO, RMAPPOConfig

    if kind == "rmappo":
        env = gt.make_env("formation_hd_env", num_agents=3, episode_length=25)
        return RMAPPO(env, RMAPPOConfig(**cfg), num_envs=num_envs, device=dev)
    env = gt.make_env("formation_hd_env", num_agents=3, discrete_action=kind == "discrete")
    return MAPPO(env, MAPPOConfig(share_policy=kind != "separated", **cfg), num_envs=num_envs, device=dev)


def onpolicy_iterations(algo, state, g, iters, label):
    """``iters`` train_step calls on the training tuple ``state``, each
    closed by a host fetch of the metrics and a finiteness check."""
    walls, host = [], {}
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, m = algo.train_step(*state, g)
        host = {k: float(v) for k, v in m.items()}
        walls.append(time.perf_counter() - t0)
        require(all(np.isfinite(v) for v in host.values()), f"{label}: non-finite metrics {host}")
    return state, host, walls


def onpolicy_split(algo, state, g):
    """One iteration as train_step runs it, with CUDA events between
    collect, prepare and update.  Returns the ms of each, the state and the
    trajectory."""
    recurrent = hasattr(algo, "_collect_recurrent")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    with torch.no_grad():
        if recurrent:
            ts, es, obs, carry = state
            es, obs, carry, traj, _, last_value = algo._collect_recurrent(ts, es, obs, carry, g)
        else:
            ts, es, obs = state
            es, obs, traj, _, last_value = algo._collect(ts, es, obs, g)
    ev[1].record()
    ts, data = algo._prepare(ts, traj, last_value)
    ev[2].record()
    ts, m = (algo._update_recurrent if recurrent else algo._update)(ts, data, g)
    ev[3].record()
    torch.cuda.synchronize()
    require(all(np.isfinite(float(v)) for v in m.values()), "split iteration: non-finite metrics")
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    state = [ts, es, obs] + ([carry] if recurrent else [])
    return dict(collect=ms[0], prepare=ms[1], update=ms[2]), state, traj


def onpolicy_card_vs_cpu(kind, dev):
    """One update on the card and on the CPU from the same networks, on one
    batch collected on the CPU from a state made with numpy, with the same
    minibatch permutations (two minibatches an epoch, so that they act).
    Tolerances of the MAPPO N=3 phase: parameters rtol 5e-3 atol 5e-5,
    v_loss 1e-3 relative."""
    import copy

    import gym_formation_tpu_torch as gt

    B, cpu_dev = 64, torch.device("cpu")
    cpu = onpolicy_algo(kind, cpu_dev, B, num_minibatches=2)
    card = onpolicy_algo(kind, dev, B, num_minibatches=2)
    g = torch.Generator()
    g.manual_seed(5)
    nets = cpu._networks(g)
    ts_cpu, ts_card = cpu.init_state(*copy.deepcopy(nets)), card.init_state(*copy.deepcopy(nets))
    st = cpu.env.scenario.pre_obs(gt.state_from_numpy(injected_state(3, B, 31)))
    obs = cpu.env.scenario.observe(st)
    gc = torch.Generator()
    gc.manual_seed(6)
    recurrent = kind == "rmappo"
    with torch.no_grad():
        if recurrent:
            _, _, _, traj, _, last = cpu._collect_recurrent(ts_cpu, st, obs, cpu.initial_carry(B), gc)
        else:
            _, _, traj, _, last = cpu._collect(ts_cpu, st, obs, gc)
    ts_cpu, data = cpu._prepare(ts_cpu, traj, last)
    cfg = cpu.cfg
    M = (cfg.rollout_len // cfg.data_chunk_length) * B if recurrent else cfg.rollout_len * B
    prng = np.random.RandomState(7)
    perms = [torch.as_tensor(prng.permutation(M)) for _ in range(cfg.ppo_epochs)]
    update = "_update_recurrent" if recurrent else "_update"
    ts_cpu, m_cpu = getattr(cpu, update)(ts_cpu, data, perms=perms)
    ts_card, m_card = getattr(card, update)(ts_card, {k: v.to(dev) for k, v in data.items()}, perms=perms)
    for (name, x), y in zip(list(ts_card.actor.named_parameters()) + list(ts_card.critic.named_parameters()),
                            ts_cpu.params()):
        check_close(x.detach().cpu(), y.detach(), 5e-5, 5e-3, f"{kind} card vs CPU update: {name}")
    v_card, v_cpu = float(m_card["v_loss"]), float(m_cpu["v_loss"])
    require(abs(v_card - v_cpu) <= 1e-3 * abs(v_cpu), f"{kind} card vs CPU update: v_loss {v_card} vs {v_cpu}")
    print(f"{kind} N=3 B={B} one {update} ({cfg.ppo_epochs} epochs x 2 minibatches, the same permutations): "
          f"card and CPU agree (params rtol 5e-3 atol 5e-5, v_loss {v_card:.6f} vs {v_cpu:.6f})")


def phase_onpolicy(dev, kmods, kind, num_envs):
    """An on-policy path at N=3 through train_step on the card: the step-by-
    step collection and the autograd update, K1 and K2 once an env step,
    K3-K9 never.  Training env-steps/s (median of 3 iterations after one
    warm-up), the split, the card against the CPU on one update, and 12
    iterations in the loose learning band of the MAPPO N=3 phase.  Returns
    the rate, the split, the launches and the 12-iteration learner."""
    algo = onpolicy_algo(kind, dev, num_envs)
    label = f"{kind} N=3 B={num_envs}"
    require(not (algo.fused_collect or algo.structured_obs or algo.cfg.fused_update),
            f"{label}: a kernel path of the shared Gaussian policy came on")
    T = algo.cfg.rollout_len
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = list(algo.init(g))
    state, _, _ = onpolicy_iterations(algo, state, g, 1, f"{label} warm-up")
    reset_counts(*kmods)
    state, _, walls = onpolicy_iterations(algo, state, g, TIMED_ITERS, label)
    counts = launch_counts(kmods)
    print(f"{label}: launches in {TIMED_ITERS} iterations {counts}")
    for name in ("pairforce_sym", "reward_sym"):
        require(counts[name] == T * TIMED_ITERS, f"{label}: {name} not once an env step")
    for name in ("fused_step", "fused_rollout", "fused_collect", "fused_ppo_grad", "pairforce", "reward",
                 "pairforce_cull"):
        require(counts[name] == 0, f"{label}: {name} launched")
    rate = T * num_envs / statistics.median(walls)
    print(f"training env-steps/s {label}: {rate:.1f} "
          f"(iteration walls {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms)")
    split, state, traj = onpolicy_split(algo, state, g)
    print(f"{label} iteration: {fmt_split(split)}")
    if kind == "discrete":
        a = traj["action"]
        require(bool(((a == 0) | (a == 1)).all()) and bool((a.sum(-1) == 1).all()),
                f"{label}: sampled actions are not one-hots")
        print(f"{label}: the {a.shape[0] * a.shape[1] * a.shape[2]} sampled actions of an iteration are one-hots")

    onpolicy_card_vs_cpu(kind, dev)

    learn = onpolicy_algo(kind, dev, num_envs)
    gl = torch.Generator(device=dev)
    gl.manual_seed(1)
    lstate = list(learn.init(gl))
    rewards = []
    for _ in range(12):
        *lstate, m = learn.train_step(*lstate, gl)
        rewards.append(float(m["mean_step_reward"]))
    require(all(np.isfinite(rewards)) and rewards[-1] > rewards[0] - 2.0,
            f"{label}: mean_step_reward left the band: {rewards}")
    print(f"{label} 12 iterations: mean_step_reward {rewards[0]:.4f} -> {rewards[-1]:.4f}")
    return dict(rate=rate, split=split, counts=counts, learner=(learn, lstate, gl))


def run_entry(args, label, timeout=600):
    """``python -m <args>`` from the checkout, as a user runs it: exit 0,
    its output printed.  Returns (stdout, wall seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], cwd=root, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    require(out.returncode == 0, f"{label} exited {out.returncode}: {out.stderr[-2000:]}")
    for line in out.stdout.splitlines():
        print(f"  {label}: {line}")
    return out.stdout, wall


def phase_eval(learner, name="rmappo", extra=("--episode-length", "25"), episodes=2):
    """eval of a checkpoint written by the path of learner ``name``, on the
    card, in a process of its own, as a user runs it: ``episodes`` episodes,
    finite returns.  Returns eval's output."""
    import shutil

    from gym_formation_tpu_torch.utils import save_checkpoint

    algo, state, g = learner
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "build", f"chip_smoke_{name}", "ckpt")
    shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    save_checkpoint(ckpt, 1, algo.checkpoint_tree(*state, g))
    stdout, wall = run_entry(["gym_formation_tpu_torch.eval", "--policy", "ckpt", "--algo", name, "--ckpt", ckpt,
                              "--episodes", str(episodes), *extra], "eval")
    returns = [float(line.split("return=")[1].split()[0]) for line in stdout.splitlines() if "return=" in line]
    require(len(returns) == episodes and all(np.isfinite(returns)), f"eval: returns {returns}")
    print(f"eval --policy ckpt --algo {name} {' '.join(extra)}: {episodes} episodes on the card in "
          f"{wall:.2f} s (process included), returns {returns}")
    return stdout


# -- the feed-forward off-policy zoo at N=3 ----------------------------------------
# kind: (algorithm name, discrete env, config overrides)
OFFPOLICY_KINDS = {
    "maddpg": ("maddpg", False, {}),
    "ddpg": ("ddpg", False, {}),
    "maddpg_discrete": ("maddpg", True, {}),
    "maddpg_per_ou": ("maddpg", False, {"use_per": True, "ou_noise": True}),
    "matd3": ("matd3", False, {}),
    "matd3_discrete": ("matd3", True, {}),
    "masac": ("masac", False, {}),
    "masac_discrete": ("masac", True, {}),
    "qmix": ("qmix", True, {}),
    "vdn": ("vdn", True, {}),
}


def offpolicy_algo(kind, dev):
    """The learner of an off-policy path at N=3 with B=32 envs and its
    config's defaults (the reference's zoo protocol: hidden (64, 64, 64),
    batch 256, a buffer of 500,000, 32 env steps and 32 updates an
    iteration; QMix its own)."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import make_algo

    name, discrete, cfg = OFFPOLICY_KINDS[kind]
    env = gt.make_env("formation_hd_env", num_agents=3, discrete_action=discrete)
    return make_algo(name, env, ZOO_ENVS, sets=[f"{k}={v}" for k, v in cfg.items()], device=dev)


def offpolicy_split(algo, state, g):
    """One iteration as train_step runs it, with CUDA events between the
    collection and the updates.  Returns the ms of each."""
    ts, buf, es, obs = state
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    with torch.no_grad():
        es, obs, _, _ = algo._collect(ts, buf, es, obs, g)
    ev[1].record()
    ms = [algo._train_once(ts, buf, g) for _ in range(algo.cfg.updates_per_iter)]
    ev[2].record()
    torch.cuda.synchronize()
    require(all(np.isfinite(float(v)) for m in ms for v in m.values()), "split iteration: non-finite metrics")
    state[2], state[3] = es, obs
    return dict(collect=ev[0].elapsed_time(ev[1]), update=ev[1].elapsed_time(ev[2]))


def _trained(ts):
    """(name, tensor) of every trained or target parameter of a state."""
    import dataclasses

    out = []
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        if isinstance(v, torch.nn.Module):
            out += [(f"{f.name}.{k}", p) for k, p in v.named_parameters()]
        elif isinstance(v, torch.nn.Parameter):
            out.append((f.name, v))
    return out


def offpolicy_card_vs_cpu(kind, dev):
    """Updates on the card and on the CPU from the same networks, on one
    batch of 256 transitions made with numpy and the same draws (PER
    weights too): every parameter, target and temperature within rtol 5e-3,
    atol 5e-5, and the losses within 1e-3 relative, as the on-policy
    phases hold them.  Two updates, so that MATD3's second skips its actor:
    there the card's actor stays as the first update left it."""
    import copy

    from gym_formation_tpu_torch.algos import QMix

    cpu, card = offpolicy_algo(kind, torch.device("cpu")), offpolicy_algo(kind, dev)
    g = torch.Generator()
    g.manual_seed(5)
    nets = cpu._networks(g)
    ts_cpu, ts_card = cpu.init_state(**copy.deepcopy(nets)), card.init_state(**copy.deepcopy(nets))
    M, N, da = cpu.cfg.batch_size, cpu.n_agents, cpu.act_dim
    rng = np.random.RandomState(8)
    for k in range(2):
        action = (np.eye(da)[rng.randint(0, da, (M, N))] if cpu.discrete
                  else rng.uniform(-1, 1, (M, N, da)))
        batch = {"obs": rng.uniform(-1.5, 1.5, (M, N, cpu.obs_dim)), "action": action,
                 "reward": rng.normal(size=(M, N)) - 3.0,
                 "next_obs": rng.uniform(-1.5, 1.5, (M, N, cpu.obs_dim)), "done": rng.uniform(size=M) < 0.1}
        batch = {k2: torch.as_tensor(v, dtype=torch.bool if k2 == "done" else torch.float32)
                 for k2, v in batch.items()}
        extra = ()
        if not isinstance(cpu, QMix):
            extra = (cpu._update_draws(g, M),)
            if getattr(cpu.cfg, "use_per", False):
                extra += (torch.as_tensor(rng.uniform(0.2, 1.0, M), dtype=torch.float32),)
        to_dev = lambda x: ({k2: v.to(dev) for k2, v in x.items()} if isinstance(x, dict) else x.to(dev))
        actor_before = [p.detach().clone() for p in ts_card.actor.parameters()] if hasattr(ts_card, "actor") else []
        m_cpu = cpu._update_once(ts_cpu, batch, *extra)
        m_card = card._update_once(ts_card, to_dev(batch), *map(to_dev, extra))
        for (name, x), (_, y) in zip(_trained(ts_card), _trained(ts_cpu)):
            check_close(x.detach().cpu(), y.detach(), 5e-5, 5e-3, f"{kind} card vs CPU update {k}: {name}")
        for key in m_cpu:
            if key == "td_abs":
                continue
            a, b = float(m_card[key]), float(m_cpu[key])
            require(abs(a - b) <= 1e-3 * abs(b) + 1e-6, f"{kind} card vs CPU update {k}: {key} {a} vs {b}")
        if kind.startswith("matd3") and k == 1:
            require(all(torch.equal(p, q) for p, q in zip(actor_before, ts_card.actor.parameters())),
                    f"{kind}: the actor moved on an update the delay skips")
    print(f"{kind} N=3 two _update_once calls of batch {M} (the same networks, batches and draws): card and CPU "
          f"agree (params rtol 5e-3 atol 5e-5, losses 1e-3)"
          + ("; the delayed update left the actor as it was" if kind.startswith("matd3") else ""))


def phase_offpolicy(dev, kmods, kind, full=True):
    """An off-policy path at N=3 through train_step on the card: one warm-up
    iteration and 3 timed ones, each closed by a host fetch of the metrics
    and a finiteness check; K1 and K2 once an env step, K3-K9 never.
    Training env-steps/s, the collect / update split, the peak device
    memory, and the path's own checks.  With ``full``, also the card
    against the CPU on two updates and 12 iterations from a fresh learner
    in the on-policy phases' loose band.  Returns the rate, split, launches,
    peak memory and the learner."""
    label = f"{kind} N=3 B={ZOO_ENVS}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    algo = offpolicy_algo(kind, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = list(algo.init(g))
    state, _, _ = onpolicy_iterations(algo, state, g, 1, f"{label} warm-up")
    reset_counts(*kmods)
    state, host, walls = onpolicy_iterations(algo, state, g, TIMED_ITERS, label)
    counts = launch_counts(kmods)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    T = algo.cfg.steps_per_iter
    print(f"{label}: launches in {TIMED_ITERS} iterations {counts}")
    for name in ("pairforce_sym", "reward_sym"):
        require(counts[name] == T * TIMED_ITERS, f"{label}: {name} not once an env step")
    for name in ("fused_step", "fused_rollout", "fused_collect", "fused_ppo_grad", "pairforce", "reward",
                 "pairforce_cull"):
        require(counts[name] == 0, f"{label}: {name} launched")
    rate = T * ZOO_ENVS / statistics.median(walls)
    print(f"training env-steps/s {label}: {rate:.1f} "
          f"(iteration walls {', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; {algo.cfg.updates_per_iter} updates "
          f"of batch {algo.cfg.batch_size} an iteration)")
    split = offpolicy_split(algo, state, g)
    print(f"{label} iteration: {fmt_split(split)}; peak device memory {peak:.1f} MiB above the "
          f"{held / 2 ** 20:.1f} MiB held before the path")
    ts, buf = state[0], state[1]
    if algo.discrete and not kind.startswith("masac"):
        a = buf.action[:buf.size]
        require(bool(((a == 0) | (a == 1)).all()) and bool((a.sum(-1) == 1).all()),
                f"{label}: stored actions are not one-hots")
        print(f"{label}: the {a.shape[0] * a.shape[1]} stored actions are one-hots")
    if getattr(algo.cfg, "use_per", False):
        pr = buf.priority[:buf.size]
        _, _, w = buf.sample_prioritized(g, algo.cfg.batch_size, algo.cfg.per_alpha, 0.4)
        require(bool(torch.isfinite(pr).all() and (pr > 0).all()), f"{label}: priorities not finite and positive")
        require(bool((w <= 1).all() and (w > 0).all()), f"{label}: PER weights outside (0, 1]")
        print(f"{label}: {buf.size} priorities finite and positive (max {float(pr.max()):.4f}), weights in (0, 1]")
    if kind.startswith("masac"):
        alpha = torch.exp(ts.log_alpha.detach()).cpu()
        require(bool((alpha != algo.cfg.init_alpha).all()), f"{label}: alpha did not move: {alpha}")
        print(f"{label}: alpha {algo.cfg.init_alpha} -> {alpha.tolist()}")
    out = dict(rate=rate, split=split, counts=counts, peak_mib=peak, learner=(algo, state, g))
    if not full:
        return out

    offpolicy_card_vs_cpu(kind, dev)
    learn = offpolicy_algo(kind, dev)
    gl = torch.Generator(device=dev)
    gl.manual_seed(1)
    lstate = list(learn.init(gl))
    rewards = []
    for _ in range(12):
        *lstate, m = learn.train_step(*lstate, gl)
        rewards.append(float(m["mean_step_reward"]))
    require(all(np.isfinite(rewards)) and min(rewards) > ZOO_FLOOR,
            f"{label}: mean_step_reward left the band: {rewards}")
    print(f"{label} 12 iterations: mean_step_reward {rewards[0]:.4f} -> {rewards[-1]:.4f} "
          f"(lowest {min(rewards):.4f}, floor {ZOO_FLOOR})")
    return out


# -- the recurrent off-policy zoo at N=3 ------------------------------------------
RECURRENT = ("rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn")
ZOO_EP_LEN = 25  # the reference's recurrent zoo protocol (RESULTS.md:322-336)
# The JAX package's own first 12 iterations at this protocol on the CPU (two
# seeds, tools/offpolicy_early_rewards.py --impl jax): RMADDPG and RMATD3
# stay within -4.24 .. -4.58, RMASAC -4.67 .. -5.08, while ε anneals RVDN
# falls to -7.43 and RQMIX to -10.77.  The floor is twice that lowest.
RECURRENT_FLOOR = -21.5


def recurrent_algo(name, dev):
    """The learner of a recurrent path at N=3 with B=32 envs, episodes of 25
    steps and its config's defaults."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import make_algo

    env = gt.make_env("formation_hd_env", num_agents=3, episode_length=ZOO_EP_LEN,
                      discrete_action=name in ("rqmix", "rvdn"))
    return make_algo(name, env, ZOO_ENVS, device=dev)


def recurrent_split(algo, state, g):
    """One iteration as train_step runs it, with CUDA events between the
    collections and the updates.  Returns the ms of each."""
    ts, buf = state
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    with torch.no_grad():
        for _ in range(algo.cfg.episodes_per_iter):
            algo._collect(ts, buf, g)
    ev[1].record()
    ms = [algo._train_once(ts, buf, g) for _ in range(algo.cfg.updates_per_iter)]
    ev[2].record()
    torch.cuda.synchronize()
    require(all(np.isfinite(float(v)) for m in ms for v in m.values()), "split iteration: non-finite metrics")
    return dict(collect=ev[0].elapsed_time(ev[1]), update=ev[1].elapsed_time(ev[2]))


def recurrent_card_vs_cpu(name, dev):
    """Two updates on the card and on the CPU from the same networks, on
    batches of 32 episodes of 26 observations made with numpy and the same
    draws: every parameter, target and temperature within rtol 5e-3, atol
    5e-5, the losses within 1e-3 relative, as the feed-forward zoo's."""
    import copy

    cpu, card = recurrent_algo(name, torch.device("cpu")), recurrent_algo(name, dev)
    g = torch.Generator()
    g.manual_seed(5)
    nets = cpu._networks(g)
    ts_cpu, ts_card = cpu.init_state(**copy.deepcopy(nets)), card.init_state(**copy.deepcopy(nets))
    M, T, N, da = cpu.cfg.batch_episodes, cpu.T, cpu.n_agents, cpu.act_dim
    rng = np.random.RandomState(8)
    to_dev = lambda x: {k: v.to(dev) for k, v in x.items()}
    for k in range(2):
        action = np.eye(da)[rng.randint(0, da, (M, T, N))] if cpu.discrete else rng.uniform(-1, 1, (M, T, N, da))
        batch = {"obs": rng.uniform(-1.5, 1.5, (M, T + 1, N, cpu.obs_dim)), "action": action,
                 "reward": rng.normal(size=(M, T, N)) - 3.0}
        batch = {k2: torch.as_tensor(v, dtype=torch.float32) for k2, v in batch.items()}
        draws = cpu._update_draws(g, M)
        m_cpu = cpu._update_once(ts_cpu, batch, draws)
        m_card = card._update_once(ts_card, to_dev(batch), to_dev(draws))
        for (pname, x), (_, y) in zip(_trained(ts_card), _trained(ts_cpu)):
            check_close(x.detach().cpu(), y.detach(), 5e-5, 5e-3, f"{name} card vs CPU update {k}: {pname}")
        for key in m_cpu:
            a, b = float(m_card[key]), float(m_cpu[key])
            require(abs(a - b) <= 1e-3 * abs(b) + 1e-6, f"{name} card vs CPU update {k}: {key} {a} vs {b}")
    print(f"{name} N=3 two _update_once calls of {M} episodes x {T} steps (the same networks, episodes and draws): "
          f"card and CPU agree (params rtol 5e-3 atol 5e-5, losses 1e-3)")


def phase_recurrent(dev, kmods, name, full=True):
    """A recurrent off-policy path at N=3 through train_step on the card: one
    warm-up iteration and 3 timed ones, each closed by a host fetch of the
    metrics and a finiteness check; K1 and K2 once an env step, K3-K9 never.
    Training env-steps/s, the collect / update split, the peak device memory
    beside the episode buffer's bytes.  With ``full``, also the card against
    the CPU on two updates and 12 iterations from a fresh learner above
    RECURRENT_FLOOR.  Returns the rate, split, launches, memory and the
    learner."""
    label = f"{name} N=3 B={ZOO_ENVS} T={ZOO_EP_LEN}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    algo = recurrent_algo(name, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = list(algo.init(g))
    state, _, _ = onpolicy_iterations(algo, state, g, 1, f"{label} warm-up")
    reset_counts(*kmods)
    state, host, walls = onpolicy_iterations(algo, state, g, TIMED_ITERS, label)
    counts = launch_counts(kmods)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    cfg = algo.cfg
    steps = cfg.episodes_per_iter * ZOO_ENVS * algo.T
    print(f"{label}: launches in {TIMED_ITERS} iterations {counts}")
    for kname in ("pairforce_sym", "reward_sym"):
        require(counts[kname] == cfg.episodes_per_iter * algo.T * TIMED_ITERS, f"{label}: {kname} not once an env step")
    for kname in ("fused_step", "fused_rollout", "fused_collect", "fused_ppo_grad", "pairforce", "reward",
                  "pairforce_cull"):
        require(counts[kname] == 0, f"{label}: {kname} launched")
    rate = steps / statistics.median(walls)
    print(f"training env-steps/s {label}: {rate:.1f} ({steps} env steps an iteration; iteration walls "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; {cfg.updates_per_iter} updates of "
          f"{cfg.batch_episodes} episodes an iteration)")
    split = recurrent_split(algo, state, g)
    buf = state[1]
    buffer_mib = sum(getattr(buf, k).numel() * getattr(buf, k).element_size() for k in buf._tensors) / 2 ** 20
    print(f"{label} iteration: {fmt_split(split)}; peak device memory {peak:.1f} MiB above the "
          f"{held / 2 ** 20:.1f} MiB held before the path (the episode buffer {buffer_mib:.1f} MiB)")
    if algo.discrete:
        a = buf.action[:buf.size]
        require(bool(((a == 0) | (a == 1)).all()) and bool((a.sum(-1) == 1).all()),
                f"{label}: stored actions are not one-hots")
        print(f"{label}: the {a.shape[0] * a.shape[1] * a.shape[2]} stored actions are one-hots; "
              f"epsilon {host['epsilon']:.4f}")
    if name == "rmasac":
        alpha = torch.exp(state[0].log_alpha.detach()).cpu()
        require(bool((alpha != cfg.init_alpha).all()), f"{label}: alpha did not move: {alpha}")
        print(f"{label}: alpha {cfg.init_alpha} -> {alpha.tolist()}")
    out = dict(rate=rate, split=split, counts=counts, peak_mib=peak, buffer_mib=buffer_mib,
               learner=(algo, state, g))
    if not full:
        return out

    recurrent_card_vs_cpu(name, dev)
    learn = recurrent_algo(name, dev)
    gl = torch.Generator(device=dev)
    gl.manual_seed(1)
    lstate = list(learn.init(gl))
    rewards = []
    t0 = time.perf_counter()
    for _ in range(12):
        *lstate, m = learn.train_step(*lstate, gl)
        rewards.append(float(m["mean_step_reward"]))
    require(all(np.isfinite(rewards)) and min(rewards) > RECURRENT_FLOOR,
            f"{label}: mean_step_reward left the band: {rewards}")
    print(f"{label} 12 iterations ({time.perf_counter() - t0:.2f} s): mean_step_reward {rewards[0]:.4f} -> "
          f"{rewards[-1]:.4f} (lowest {min(rewards):.4f}, floor {RECURRENT_FLOOR})")
    return out


def phase_k1k2_n3(dev, rng):
    """K1 and K2 against their plain versions at the N=3 paths' shape (the
    hd env's colliding subset: 3 agents of size 0.03), B=32 (the off-policy
    zoo), 128 and 512: random states, pairs in exact contact, in deep
    penetration and at zero distance; K1 atol = rtol = 1e-3, K2 Hausdorff
    atol 1e-5, counts equal, two launches bit for bit.  Returns each
    kernel's max error and its time beside its plain version's and its
    bound at B=32 and 512."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core.physics import _collide_subset
    from gym_formation_tpu_torch.ops.kernels import pairforce_sym as k1
    from gym_formation_tpu_torch.ops.kernels import reward_sym as k2

    n = 3
    _, _, _, cfg = _collide_subset(gt.make_env("formation_hd_env", num_agents=n).cfg)
    p = k1._params(cfg)
    errs = {"k1": 0.0, "k2": 0.0}
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    for B in (ZOO_ENVS, RMAPPO_ENVS, MAPPO_ENVS):
        contact = rng.uniform(-0.5, 0.5, (B, n, 2))
        third = B // 3
        contact[:third, 1] = contact[:third, 0] + [0.06, 0.0]  # exact contact (K1: 2 x size)
        contact[third:2 * third, 1] = contact[third:2 * third, 0] + [0.0, 0.03]  # at K2's threshold
        contact[2 * third:, 2] = contact[2 * third:, 1]  # zero distance
        for label, pos in (("random", rng.uniform(-0.5, 0.5, (B, n, 2))), ("contact", contact),
                           ("all in contact", rng.uniform(-0.02, 0.02, (B, n, 2)))):
            pos = f(pos)
            got = k1.collision_forces_sym(pos, cfg)
            want = k1.collision_forces_sym_plain(pos, **p)
            again = k1.collision_forces_sym(pos, cfg)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"K1 n=3 {label} B={B}: non-finite forces")
            errs["k1"] = max(errs["k1"], check_close(got, want, 1e-3, 1e-3, f"K1 n=3 {label} B={B}"))
            require(torch.equal(got, again), f"K1 n=3 {label} B={B}: two launches differ")
            ish = rng.uniform(-1, 1, (B, n, 2))
            ish = f(ish - ish.mean(1, keepdims=True))
            h, nc = k2.hd_reward_stats_sym(pos, ish, thresh=THRESH)
            h_p, nc_p = k2.hd_reward_stats_sym_plain(pos, ish, thresh=THRESH)
            h2, nc2 = k2.hd_reward_stats_sym(pos, ish, thresh=THRESH)
            errs["k2"] = max(errs["k2"], check_close(h, h_p, 1e-5, 0.0, f"K2 n=3 {label} B={B} haus"))
            require(torch.equal(nc, nc_p), f"K2 n=3 {label} B={B}: counts differ")
            require(torch.equal(h, h2) and torch.equal(nc, nc2), f"K2 n=3 {label} B={B}: two launches differ")
            if label != "random":
                require(int(nc.sum()) > 0, f"K2 n=3 {label} B={B}: no collisions")
            print(f"K1/K2 n=3 {label} B={B}: K1 max abs err {max_err(got, want):.3e} (atol=rtol=1e-3), "
                  f"K2 haus {max_err(h, h_p):.3e} (atol 1e-5), counts equal ({int(nc.sum())} collisions), "
                  f"two launches bit for bit")
    out = {}
    for B in (ZOO_ENVS, MAPPO_ENVS):
        pos, ish = f(rng.uniform(-0.5, 0.5, (B, n, 2))), f(rng.uniform(-1, 1, (B, n, 2)))
        for name, kern, plain, bnd in (
                ("K1", lambda: k1.collision_forces_sym(pos, cfg), lambda: k1.collision_forces_sym_plain(pos, **p),
                 bound(16 * B * n, B * pair_ops(n * (n - 1)))),
                ("K2", lambda: k2.hd_reward_stats_sym(pos, ish, thresh=THRESH),
                 lambda: k2.hd_reward_stats_sym_plain(pos, ish, thresh=THRESH),
                 bound(16 * B * n + 4 * B + 4 * B * n, B * stat_ops(n)))):
            ms, plain_ms = time_pair(kern, plain)
            out[name, B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1])
            print(f"{name} n=3 B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.6f} ms "
                  f"({bnd[1]})")
    return errs, out


# -- the user-facing surface (phases 36-39) ------------------------------------
SURFACE_N = 9  # the wrapper phase: formation_hd at N=9, BFS arity 3 over two levels
SURFACE_STEPS = 100  # wrapper steps checked (the first 10 against the CPU) and per timed window
FRAME_PX = 350  # the demo's and eval's frame size


def wrapper_obs(w):
    """The observation list of a wrapper's injected state."""
    scen = w._env.scenario
    return list(scen.observe(scen.pre_obs(w.state))[0].cpu().numpy())


def phase_wrappers(dev, kmods):
    """GymMultiAgentEnv on the card (no device argument) from an injected
    compat.host_reset(seed=1), 10 steps under get_action_BFS against the same
    wrapper on the CPU, then 90 more; K1 and K2 once a step; DictAgentEnv 5
    steps; the renderer on the card state; the wrapper's steps/s (median of 3
    windows of 100 steps).  Returns the rate, the render times and the
    launches."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch import compat
    from gym_formation_tpu_torch.render import render_state, render_state_per_agent, tile_images

    n = SURFACE_N
    card = gt.GymMultiAgentEnv("formation_hd_env", benchmark=True, num_agents=n)
    cpu = gt.GymMultiAgentEnv("formation_hd_env", benchmark=True, num_agents=n, device="cpu")
    require(card.device.type == "cuda", f"the wrapper's default device is {card.device}")
    for w in (card, cpu):
        w.state = compat.host_reset(w._env.scenario, seed=1, device=w.device)
    obs_c, obs_p = wrapper_obs(card), wrapper_obs(cpu)
    torch.cuda.synchronize()
    reset_counts(*kmods)
    for t in range(10):
        out_c = card.step(gt.get_action_BFS(gt.ezpolicy, obs_c, 3))
        out_p = cpu.step(gt.get_action_BFS(gt.ezpolicy, obs_p, 3, device="cpu"))
        (obs_c, r_c, d_c, i_c), (obs_p, r_p, d_p, i_p) = out_c, out_p
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
        # the env's card-against-CPU tolerances (phase 5): vel's for the
        # observations, which hold velocities and positions; reward's for
        # the rewards and the info quartet
        check_close(f(np.stack(obs_c)), f(np.stack(obs_p)), 2e-3, 1e-4, f"wrapper step {t} obs")
        check_close(f(r_c), f(r_p), 1e-4, 1e-5, f"wrapper step {t} reward")
        require(d_c == d_p, f"wrapper step {t}: done flags {d_c} against {d_p}")
        require(len(i_c) == n and all(set(a) == set(b) for a, b in zip(i_c, i_p)), f"wrapper step {t}: info keys")
        for k in i_c[0]:
            check_close(f([a[k] for a in i_c]), f([a[k] for a in i_p]), 1e-4, 1e-5, f"wrapper step {t} info {k}")
    print(f"GymMultiAgentEnv N={n} on {card.device}: 10 steps under get_action_BFS agree with the CPU wrapper "
          f"(obs {max_err(f(np.stack(obs_c)), f(np.stack(obs_p))):.2e}, reward "
          f"{max_err(f(r_c), f(r_p)):.2e}), done flags equal")
    episodes = 0
    for _ in range(SURFACE_STEPS - 10):
        obs_c, r_c, d_c, i_c = card.step(gt.get_action_BFS(gt.ezpolicy, obs_c, 3))
        require(np.isfinite(np.stack(obs_c)).all() and np.isfinite(r_c).all(), "wrapper: non-finite step")
        if all(d_c):
            obs_c, episodes = card.reset(), episodes + 1
    counts = launch_counts(kmods)
    print(f"{SURFACE_STEPS} wrapper steps ({episodes} episode ends): launches {counts}")
    for name, c in counts.items():
        want = SURFACE_STEPS if name in ("pairforce_sym", "reward_sym") else 0
        require(c == want, f"wrapper path: {name} launched {c} times in {SURFACE_STEPS} steps")

    d = gt.DictAgentEnv(scenario_name="formation_hd_env", num_agents=n)
    d.seed(5)
    o = d.reset()
    for _ in range(5):
        o, r, done, info = d.step({i: np.zeros(2, np.float32) for i in range(n)})
        require(set(o) == set(r) == set(range(n)) and set(done) == set(range(n)) | {"__all__"},
                "DictAgentEnv: keys")
        require(done["__all__"] is False and info[0] == {"done": False}, "DictAgentEnv: done or info")
    print(f"DictAgentEnv N={n}: 5 steps, keys and __all__ kept")

    frame = render_state(card._env.scenario, card.state, size=FRAME_PX)
    views = render_state_per_agent(card._env.scenario, card.state, size=233)
    tiled = tile_images(np.stack(views))
    require(frame.dtype == np.uint8 and frame.shape == (FRAME_PX, FRAME_PX, 3), f"frame {frame.shape}")
    require(len(views) == n and all(v.dtype == np.uint8 and v.shape == (233, 233, 3) for v in views), "views")
    require(tiled.shape == (3 * 233, 3 * 233, 3), f"tiled views {tiled.shape}")
    render_ms = {}
    for N in (n, NUM_AGENTS):
        scen = gt.make_scenario("formation_hd_env", num_agents=N)
        st = compat.host_reset(scen, seed=1, device=dev)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            render_state(scen, st, size=FRAME_PX)
            walls.append((time.perf_counter() - t0) * 1e3)
        render_ms[N] = statistics.median(walls)
    print(f"render_state {FRAME_PX} px (host numpy, median of 3): " + ", ".join(
        f"N={N} {ms:.3f} ms" for N, ms in render_ms.items()) + f"; per-agent views tiled {tiled.shape}")

    rates, step_ms = [], []
    for _ in range(3):
        obs_c, in_step = card.reset(), 0.0
        t0 = time.perf_counter()
        for _ in range(SURFACE_STEPS):
            acts = gt.get_action_BFS(gt.ezpolicy, obs_c, 3)
            s0 = time.perf_counter()
            obs_c, r_c, d_c, _ = card.step(acts)
            in_step += time.perf_counter() - s0
            if all(d_c):
                obs_c = card.reset()
        rates.append(SURFACE_STEPS / (time.perf_counter() - t0))
        step_ms.append(in_step * 1e3 / SURFACE_STEPS)
    rate = statistics.median(rates)
    print(f"wrapper steps/s N={n} under get_action_BFS: median {rate:.1f} (windows of {SURFACE_STEPS}: "
          f"{', '.join(f'{r:.1f}' for r in rates)}); step() alone {statistics.median(step_ms):.4f} ms")
    return dict(rate=rate, step_ms=statistics.median(step_ms), render_ms=render_ms, counts=counts)


def gif_line(stdout, path, label):
    """The GIF path, or the JAX package's line where imageio is missing."""
    wrote = f"gif → {path}" in stdout
    require(wrote or "imageio unavailable" in stdout, f"{label}: neither a GIF nor the imageio line")
    return wrote


def phase_demo():
    """``python -m gym_formation_tpu_torch.demo -n 3 --num-layer 5 --steps 20
    --gif``: N=243 on the card, finite first and last rewards."""
    gif = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_demo.gif")
    os.makedirs(os.path.dirname(gif), exist_ok=True)
    stdout, wall = run_entry(["gym_formation_tpu_torch.demo", "-n", "3", "--num-layer", "5", "--steps", "20",
                              "--gif", gif], "demo")
    line = next((s for s in stdout.splitlines() if "reward first/last" in s), "")
    first, last = (float(x) for x in line.split("reward first/last:")[1].split("/"))
    require("243 agents, 20 steps" in line and np.isfinite([first, last]).all(), f"demo: {line!r}")
    wrote = gif_line(stdout, gif, "demo")
    print(f"demo N=243, 20 steps with frames of {FRAME_PX} px: {wall:.2f} s (process included), rewards "
          f"{first} -> {last}, gif {'written' if wrote else 'not written (no imageio)'}")
    return wall


def phase_profiling(dev, kmods):
    """trace() over 8 steps of the step path at N=243, B=4096 inside
    named_scope("step"): the trace names the scope and K1's and K2's CUDA
    kernels; assert_finite on the state and on a copy with a NaN in vel;
    Throughput's rate; the trace's overhead (traced window against untraced
    ones)."""
    import glob
    import shutil

    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.utils import Throughput, assert_finite, named_scope, trace

    steps = 8
    venv = gt.make_vec_env("formation_hd_env", num_envs=NUM_ENVS, num_agents=NUM_AGENTS, device=dev, seed=3)
    scen = venv.env.scenario
    policy = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, scen, s, 3)
    state = venv.reset_state()
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_trace")
    shutil.rmtree(log_dir, ignore_errors=True)

    def window():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with named_scope("step"):
            state, rs = gt.rollout_statepolicy_rewardsum(venv.env, policy, state, venv.generator, steps)
        rs = rs.cpu()
        require(bool(torch.isfinite(rs).all()), "profiling: non-finite reward sums")
        return time.perf_counter() - t0

    window()  # warm-up
    plain = [window()]
    reset_counts(*kmods)
    with trace(log_dir):
        traced = window()
    counts = launch_counts(kmods)
    meter = Throughput(report_every=2)
    meter.tick(0)  # starts its clock
    for _ in range(2):  # untraced windows, the counter's report at the second
        plain.append(window())
        rate = meter.tick(NUM_ENVS * steps)
    require(rate is not None and rate > 0, f"Throughput: rate {rate}")
    for name in ("pairforce_sym", "reward_sym"):
        require(counts[name] == steps, f"traced window: {name} launched {counts[name]} times in {steps} steps")
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    require(len(files) == 1, f"trace files {files}")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    require(kernels, "the trace holds no CUDA kernel event (CUPTI recorded none)")
    scope = [e for e in events if e.get("name") == "step" and e.get("cat") != "kernel"]
    require(scope, "the trace does not name the scope 'step'")
    found = {k: sum(k in name for name in kernels) for k in ("pairforce_sym_kernel", "reward_sym_kernel")}
    require(all(found[k] == steps for k in found), f"K1 and K2 kernel events in the trace: {found}")
    size = os.path.getsize(files[0])

    assert_finite(state)
    bad = state.replace(vel=state.vel.clone())
    bad.vel[0, 0, 0] = float("nan")
    try:
        assert_finite(bad)
        raise SmokeFailure("assert_finite passed a state with a NaN in vel")
    except FloatingPointError as e:
        require("'.vel'" in str(e) and "'.pos'" not in str(e), f"assert_finite: {e}")
    base = statistics.mean(plain)
    print(f"trace of {steps} steps N={NUM_AGENTS} B={NUM_ENVS}: {len(events)} events, {len(kernels)} kernels "
          f"({found}), scope 'step' x{len(scope)}, {size / 2**20:.2f} MiB")
    print(f"trace overhead: traced window {traced * 1e3:.3f} ms, untraced {', '.join(f'{w * 1e3:.3f}' for w in plain)}"
          f" ms: {traced / base:.3f}x; Throughput {rate:.1f} env-steps/s; assert_finite passes the state and "
          f"names .vel on a NaN")
    return dict(overhead=traced / base, traced_ms=traced * 1e3, plain_ms=base * 1e3, rate=rate, counts=counts)


# -- 40. data parallel ------------------------------------------------------------
DP_WORLD = 2  # ranks of the gloo world, all on the one card
DP_ROLLOUT = (243, 4096, 128)  # N, global B, steps of the sharded fused rollout
DP_MAPPO_N3 = (4096, 3)  # global B, iterations
DP_MAPPO_N243 = (1024, 2)
DP_MADDPG = (32, 2)
DP_GATE = dict(rtol=5e-3, atol=5e-5)  # the learners' card-against-CPU gate of phases 12-13
DP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_dp")


def _dp_kmods():
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9
    from gym_formation_tpu_torch.ops.kernels import fused_step as k3
    from gym_formation_tpu_torch.ops.kernels import pairforce_sym as k1
    from gym_formation_tpu_torch.ops.kernels import reward_sym as k2

    return k1, k2, k3, k5, k9


def _dp_sync(mesh):
    torch.cuda.synchronize()
    if mesh is not None:
        torch.distributed.barrier()


def _dp_train(algo, mesh, g, iters, label):
    """``iters`` train_step calls from a fresh init (rank 0's networks on
    every rank), each closed by a host fetch of the metrics; the kernels'
    launches and the collectives counted over them.  Returns the
    parameters after each iteration, the walls, the launches and the
    all_reduce calls and ms."""
    from gym_formation_tpu_torch import parallel
    from gym_formation_tpu_torch.parallel import mesh as dp
    from gym_formation_tpu_torch.parallel import tensor

    kmods = _dp_kmods()
    state = algo.init(g)
    parallel.shard_params_(parallel.replicate_global(state[0], mesh), mesh)
    first = []  # the first optimizer step's (reduced) gradient, the rank's slices
    if hasattr(algo, "_apply"):  # MAPPO
        apply = algo._apply

        def keep_first(ts, grads):
            if not first:
                first.extend((g_.detach().clone(), p) for g_, p in zip(grads, ts.params()))
            apply(ts, grads)

        algo._apply = keep_first
    reset_counts(*kmods)
    dp.reset_stats(timing=True)
    params, walls = [], []
    for _ in range(iters):
        _dp_sync(mesh)
        t0 = time.perf_counter()
        *state, m = algo.train_step(*state, g)
        host = {k: float(v) for k, v in m.items()}
        _dp_sync(mesh)
        walls.append(time.perf_counter() - t0)
        require(all(np.isfinite(v) for v in host.values()), f"{label}: non-finite metrics {host}")
        params.append([p.detach().cpu().clone() for p in _dp_nets(state[0])])
    model = ("model_all_gather", "model_all_reduce")
    out = dict(walls=walls, counts=launch_counts(kmods), all_reduce=dp.stats["all_reduce"],
               all_gather=dp.stats["all_gather"], collective_ms=dp.collective_ms(),
               model_calls={k: dp.stats[k] for k in model}, model_ms=dp.collective_ms(model))
    # on a model axis (after the counts): the rank's slices as held, then
    # the last parameters and the first gradient gathered whole
    ts, whole_ts = state[0], tensor.whole_state(state[0], mesh)
    out["local"] = params[-1]
    out["cut"] = [tensor.cut_of(p) is not None for p in _dp_nets(ts)]
    out["held"], out["held_whole"] = tensor.held_bytes(ts), tensor.held_bytes(whole_ts)
    params[-1] = [p.detach().cpu().clone() for p in _dp_nets(whole_ts)]
    whole = lambda t, p: t if tensor.cut_of(p) is None else tensor.cut_of(p).whole(t)
    return dict(out, params=params, first_grad=[whole(t, p).cpu() for t, p in first])


def _dp_nets(ts):
    """The parameters the data-parallel and tensor-parallel phases hold."""
    return (list(ts.params()) if hasattr(ts, "params") else
            [p for f in ("actor", "critic") for p in getattr(ts, f).parameters()])


def dp_programs(mesh, dev):
    """The phase's four paths on this process: the whole batch without a
    mesh, the rank's share under one."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch import parallel
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig, make_algo

    out = {}
    g = torch.Generator(device=dev)
    # the sharded fused rollout (K3 and the masked K2), the N=243 bfs_state row
    n, B, T = DP_ROLLOUT
    env = gt.make_env("formation_hd_env", num_agents=n)
    g.manual_seed(21)
    state = env.reset_state(g, B)  # the global batch, on every rank
    kmods = _dp_kmods()
    _dp_sync(mesh)
    reset_counts(*kmods)
    t0 = time.perf_counter()
    if mesh is None:
        st, rew = gt.rollout_statepolicy_fused(env, None, state, g, T, policy="bfs_ez")
    else:
        st, rew = gt.rollout_statepolicy_fused_sharded(env, None, parallel.shard_batch(state, mesh), g, T, mesh,
                                                       policy="bfs_ez")
    _dp_sync(mesh)
    wall = time.perf_counter() - t0
    counts = launch_counts(kmods)
    st = parallel.host_local_to_global(st, mesh)
    rew = parallel.host_local_to_global(rew.T.contiguous(), mesh).T
    out["rollout"] = dict(state={k: v.cpu() for k, v in st.__dict__.items()}, rewards=rew.cpu(), counts=counts,
                          wall=wall)
    del state, st, rew
    # MAPPO N=3: K5 (with the rank's env offset) and K9 (global counts)
    B, iters = DP_MAPPO_N3
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3, mesh=mesh), MAPPOConfig(fused_update=True),
                 num_envs=B, device=dev)
    require(algo.fused_collect, "data parallel: the auto gate did not turn fused_collect on")
    g.manual_seed(0)
    out["mappo_n3"] = _dp_train(algo, mesh, g, iters, "data parallel MAPPO N=3")
    # MAPPO N=243 on the structured path (K1, K2)
    B, iters = DP_MAPPO_N243
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=243, mesh=mesh), MAPPOConfig(), num_envs=B,
                 device=dev)
    require(algo.structured_obs, "data parallel: N=243 MAPPO did not take the structured path")
    g.manual_seed(1)
    out["mappo_n243"] = _dp_train(algo, mesh, g, iters, "data parallel MAPPO N=243")
    del algo
    # MADDPG N=3 (K1, K2): gathered transitions, replicated updates
    B, iters = DP_MADDPG
    algo = make_algo("maddpg", gt.make_env("formation_hd_env", num_agents=3), B, device=dev, mesh=mesh)
    g.manual_seed(2)
    out["maddpg"] = _dp_train(algo, mesh, g, iters, "data parallel MADDPG")
    return out


def dp_world_rank(mesh, out_dir):
    """A rank of the phase's gloo world: the four paths on its share."""
    from gym_formation_tpu_torch.parallel import mesh as dp

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.save(dp_programs(mesh, dev), os.path.join(out_dir, f"gloo_rank{dp.rank(mesh)}.pt"))


def dp_nccl_rank(mesh, out_dir):
    """The one rank of the phase's nccl world: MAPPO N=3 fused, 2 iterations."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3, mesh=mesh), MAPPOConfig(fused_update=True),
                 num_envs=DP_MAPPO_N3[0], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    torch.save(_dp_train(algo, mesh, g, 2, "nccl MAPPO N=3"), os.path.join(out_dir, "nccl_rank0.pt"))


def _dp_rate(res, env_steps):
    """env-steps/s over the iterations after the first."""
    return env_steps / statistics.median(res["walls"][1:] or res["walls"])


def _dp_close(got, want, what):
    err = 0.0
    for a, b in zip(got, want, strict=True):
        err = max(err, check_close(a, b, DP_GATE["atol"], DP_GATE["rtol"], what))
    return err


def _dp_grad_close(got, want, what):
    """The first optimizer step's gradient, summed over the ranks, against
    the single process's: rtol 5e-3 and an atol of 1e-4 of the gradient's
    largest entry (float32 sums over the batch's rows in another order).
    Returns the largest error relative to that entry."""
    scale = max(float(b.abs().max()) for b in want) or 1.0
    for a, b in zip(got, want, strict=True):
        check_close(a, b, 1e-4 * scale, DP_GATE["rtol"], what)
    return max(max_err(a, b) for a, b in zip(got, want)) / scale


def _dp_param_spread(got, want):
    """(max abs error, share of entries outside the learners' gate) of two
    parameter lists."""
    err, over, total = 0.0, 0, 0
    for a, b in zip(got, want, strict=True):
        d = (a.double() - b.double()).abs()
        err = max(err, float(d.max()))
        over += int((d > DP_GATE["atol"] + DP_GATE["rtol"] * b.double().abs()).sum())
        total += d.numel()
    return err, over / total


def phase_data_parallel(dev, card):
    """K5 with an env offset against its plain version; the four paths in
    a world of 2 processes (gloo) on the one card against this process's
    unsharded runs; MAPPO N=3 in a world of 1 (nccl)."""
    import shutil

    from gym_formation_tpu_torch import parallel
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
    from gym_formation_tpu_torch.ops.kernels import fused_rollout as k4

    t_phase = time.perf_counter()
    # K5 at the offset of rank 1 (of 2) against its plain version, and
    # against rows [offset, B) of one launch over the whole batch
    n, B, T, ep_len, off = 3, NUM_ENVS, 25, 10, NUM_ENVS // 2
    import gym_formation_tpu_torch as gt

    v = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, device=dev, seed=5)
    soa = k4.state_to_soa(v.reset_state())
    rng = np.random.RandomState(40)
    soa = soa._replace(t=torch.as_tensor(rng.randint(0, ep_len, (1, B)), dtype=torch.int32, device=dev))
    actor, critic = random_networks(n, 7, dev)
    aops, cops = k5.actor_planes(actor), k5.critic_planes(critic)
    part = soa._replace(**{f: getattr(soa, f)[:, off:].contiguous() for f in soa._fields})
    kw = dict(length=T, ep_len=ep_len, n=n)
    s_k, tr_k = k5.fused_collect_hd(part, aops, cops, 9, env_offset=off, **kw)
    s_p, tr_p = k5.fused_collect_hd_plain(part, aops, cops, 9, env_offset=off, **kw)
    _, tr_whole = k5.fused_collect_hd(soa, aops, cops, 9, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for f in ("ap", "av", "ishape", "ivel"):
        err = max(err, check_close(getattr(s_k, f), getattr(s_p, f), 1e-5, 0.0, f"K5 offset {f}"))
    for k in ("obs", "action", "logp", "value", "reward"):
        err = max(err, check_close(tr_k[k], tr_p[k], 1e-4, 1e-5, f"K5 offset {k}"))
    require(torch.equal(s_k.t, s_p.t) and torch.equal(tr_k["done"], tr_p["done"]), "K5 offset: counters differ")
    require(bool(tr_k["done"].any(0).all()), "K5 offset: not every env reset")
    same = all(torch.equal(tr_k[k], tr_whole[k][:, off:]) for k in tr_k)
    print(f"K5 n=3 B={B - off} env_offset={off}: max abs err {err:.3e} against its plain version (state atol "
          f"1e-5; trajectory atol 1e-4 rtol 1e-5); bit for bit with rows [{off}, {B}) of one launch over "
          f"B={B}: {same}")

    # the unsharded runs in this process
    ref = dp_programs(None, dev)
    torch.cuda.empty_cache()
    # the gloo world of 2 ranks on the one card, and the nccl world of 1
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    t0 = time.perf_counter()
    parallel.spawn(dp_world_rank, DP_WORLD, (DP_DIR,), backend="gloo", device_type="cuda")
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parallel.spawn(dp_nccl_rank, 1, (DP_DIR,), backend="nccl", device_type="cuda")
    nccl_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(DP_DIR, f"gloo_rank{r}.pt"), weights_only=False) for r in range(DP_WORLD)]
    nccl = torch.load(os.path.join(DP_DIR, "nccl_rank0.pt"), weights_only=False)
    w2 = ranks[0]

    # the sharded fused rollout: bit for bit (each env's arithmetic does not
    # depend on the batch it is launched in)
    n, B, T = DP_ROLLOUT
    r1, r2 = ref["rollout"], w2["rollout"]
    bitwise = torch.equal(r1["rewards"], r2["rewards"]) and all(
        torch.equal(r1["state"][k], r2["state"][k]) for k in r1["state"])
    if not bitwise:  # a finding: held to the K3 gate
        check_close(r2["state"]["pos"], r1["state"]["pos"], 2e-4, 0.0, "sharded rollout pos")
        check_close(r2["state"]["vel"], r1["state"]["vel"], 2e-3, 0.0, "sharded rollout vel")
        check_close(r2["rewards"], r1["rewards"], 1e-5 * n * n, 1e-5, "sharded rollout rewards")
    for r, rank in enumerate(ranks):
        c = rank["rollout"]["counts"]
        require(c["fused_step"] == T and c["reward_sym"] == T + 1 and c["pairforce_sym"] == 0,
                f"sharded rollout rank {r}: launches {c}")
    print(f"sharded fused rollout N={n} B={B} ({B // DP_WORLD} a rank) {T} steps bfs_ez: gathered rewards "
          f"[{T}, {B}] and final state bit for bit with the unsharded run: {bitwise}; launches a rank "
          f"{ranks[0]['rollout']['counts']['fused_step']} K3, {ranks[0]['rollout']['counts']['reward_sym']} "
          f"masked K2; wall W=1 {r1['wall'] * 1e3:.3f} ms, W=2 {r2['wall'] * 1e3:.3f} ms ({card})")

    # MAPPO N=3 fused: K5 once an iteration a rank (offsets 0 and B/2), K9
    # once an epoch
    B, iters = DP_MAPPO_N3
    epochs = 10
    err = _dp_close(w2["mappo_n3"]["params"][-1], ref["mappo_n3"]["params"][-1], "data parallel MAPPO N=3")
    grel = _dp_grad_close(w2["mappo_n3"]["first_grad"], ref["mappo_n3"]["first_grad"],
                          "data parallel MAPPO N=3 first gradient")
    for r, rank in enumerate(ranks):
        c = rank["mappo_n3"]["counts"]
        require(c["fused_collect"] == iters and c["fused_ppo_grad"] == iters * epochs,
                f"data parallel MAPPO N=3 rank {r}: launches {c}")
        require(all(torch.equal(a, b) for a, b in zip(rank["mappo_n3"]["params"][-1], w2["mappo_n3"]["params"][-1])),
                f"data parallel MAPPO N=3: rank {r}'s parameters differ from rank 0's")
    steps = 25 * B
    ar = w2["mappo_n3"]
    print(f"data parallel MAPPO N=3 B={B} fused, {iters} iterations: parameters against the unsharded run max "
          f"abs err {err:.3e} (rtol {DP_GATE['rtol']}, atol {DP_GATE['atol']}), the first step's gradient's "
          f"{grel:.3e} of its largest entry; launches a rank "
          f"{ar['counts']['fused_collect']} K5, {ar['counts']['fused_ppo_grad']} K9")
    print(f"training env-steps/s MAPPO N=3 B={B} fused: W=1 {_dp_rate(ref['mappo_n3'], steps):.1f}, W=2 on one "
          f"card (gloo) {_dp_rate(ar, steps):.1f}; all_reduce {ar['all_reduce'] / iters:.1f} calls and "
          f"{ar['collective_ms'] / iters:.3f} ms an iteration (CUDA events, rank 0) ({card})")

    # MAPPO N=243 structured: K1 and K2 once an env step a rank.  Adam's
    # first steps move each weight by about lr · sign(g), so a weight whose
    # gradient is near zero takes the float32 reordering of its gradient's
    # sum as a different sign: the parameters are held through the first
    # step's gradient, and their spread is reported
    B, iters = DP_MAPPO_N243
    grel = _dp_grad_close(w2["mappo_n243"]["first_grad"], ref["mappo_n243"]["first_grad"],
                          "data parallel MAPPO N=243 first gradient")
    err, over = _dp_param_spread(w2["mappo_n243"]["params"][-1], ref["mappo_n243"]["params"][-1])
    require(err <= 2 * 7e-4 * 10 * iters, f"data parallel MAPPO N=243: parameters apart by {err:.3e}, more than "
            f"sign flips of {10 * iters} Adam steps give")
    for r, rank in enumerate(ranks):
        c = rank["mappo_n243"]["counts"]
        require(c["pairforce_sym"] == iters * 25 and c["reward_sym"] == iters * 25 and c["fused_collect"] == 0,
                f"data parallel MAPPO N=243 rank {r}: launches {c}")
        require(all(torch.equal(a, b) for a, b in zip(rank["mappo_n243"]["params"][-1],
                                                     w2["mappo_n243"]["params"][-1])),
                f"data parallel MAPPO N=243: rank {r}'s parameters differ from rank 0's")
    ar = w2["mappo_n243"]
    print(f"data parallel MAPPO N=243 structured B={B}, {iters} iterations: the first step's gradient within "
          f"rtol 5e-3 (largest error {grel:.3e} of the gradient's largest entry); parameters max abs err {err:.3e}, "
          f"{over:.3e} of them outside rtol 5e-3 atol 5e-5; "
          f"launches a rank {ar['counts']['pairforce_sym']} K1, {ar['counts']['reward_sym']} K2; training "
          f"env-steps/s W=1 {_dp_rate(ref['mappo_n243'], 25 * B):.1f}, W=2 {_dp_rate(ar, 25 * B):.1f}; "
          f"all_reduce {ar['all_reduce'] / iters:.1f} calls and {ar['collective_ms'] / iters:.3f} ms an "
          f"iteration ({card})")

    # MADDPG N=3: every rank's parameters bit for bit, and the single process's
    B, iters = DP_MADDPG
    for r, rank in enumerate(ranks):
        c = rank["maddpg"]["counts"]
        require(c["pairforce_sym"] == iters * 32 and c["reward_sym"] == iters * 32,
                f"data parallel MADDPG rank {r}: launches {c}")
        require(all(torch.equal(a, b) for a, b in zip(rank["maddpg"]["params"][-1], w2["maddpg"]["params"][-1])),
                f"data parallel MADDPG: rank {r}'s parameters differ from rank 0's")
    same = all(torch.equal(a, b) for a, b in zip(w2["maddpg"]["params"][-1], ref["maddpg"]["params"][-1]))
    if not same:  # a finding: held to the learners' gate
        _dp_close(w2["maddpg"]["params"][-1], ref["maddpg"]["params"][-1], "data parallel MADDPG")
    ar = w2["maddpg"]
    print(f"data parallel MADDPG N=3 B={B}, {iters} iterations: both ranks' parameters bit for bit; equal to the "
          f"unsharded run bit for bit: {same}; launches a rank {ar['counts']['pairforce_sym']} K1, "
          f"{ar['counts']['reward_sym']} K2; all_gather {ar['all_gather'] / iters:.1f} calls and "
          f"{ar['collective_ms'] / iters:.3f} ms an iteration; training env-steps/s W=1 "
          f"{_dp_rate(ref['maddpg'], 32 * B):.1f}, W=2 {_dp_rate(ar, 32 * B):.1f} ({card})")

    # the nccl world of 1: MAPPO N=3 fused, 2 iterations, against the
    # unsharded run's second iteration
    err = _dp_close(nccl["params"][-1], ref["mappo_n3"]["params"][1], "nccl MAPPO N=3")
    require(nccl["counts"]["fused_collect"] == 2 and nccl["counts"]["fused_ppo_grad"] == 20,
            f"nccl MAPPO N=3: launches {nccl['counts']}")
    print(f"nccl world of 1: MAPPO N=3 B={DP_MAPPO_N3[0]} fused, 2 iterations: parameters max abs err {err:.3e} "
          f"against the unsharded run; all_reduce {nccl['all_reduce'] / 2:.1f} calls and "
          f"{nccl['collective_ms'] / 2:.3f} ms an iteration ({card})")
    print(f"data parallel phase: {time.perf_counter() - t_phase:.1f} s (gloo world {gloo_s:.1f} s, nccl world "
          f"{nccl_s:.1f} s, each with its processes' start)")
    return ref


TP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_tp")
TP_MAPPO_N243 = (1024, 1, dict(ppo_epochs=1))  # global B, iterations, config
TP_RMAPPO = (128, 2)


def tp_programs(mesh, dev, ref=None):
    """The tensor-parallel phase's paths on this process: on ``mesh`` (a
    model axis of 2) or, with ``ref`` (phase 40's unsharded runs), those
    of them that phase 40 does not run."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig, make_algo

    out = {}
    g = torch.Generator(device=dev)
    if ref is None:
        B, iters = DP_MAPPO_N3
        algo = MAPPO(gt.make_env("formation_hd_env", num_agents=3, mesh=mesh), MAPPOConfig(fused_update=True),
                     num_envs=B, device=dev)
        require(algo.fused_collect, "tensor parallel: the auto gate did not turn fused_collect on")
        g.manual_seed(0)
        out["mappo_n3"] = _dp_train(algo, mesh, g, iters, "tensor parallel MAPPO N=3")
        B, iters = DP_MADDPG
        algo = make_algo("maddpg", gt.make_env("formation_hd_env", num_agents=3), B, device=dev, mesh=mesh)
        g.manual_seed(2)
        out["maddpg"] = _dp_train(algo, mesh, g, iters, "tensor parallel MADDPG")
    B, iters, cfg = TP_MAPPO_N243
    algo = MAPPO(gt.make_env("formation_hd_env", num_agents=243, mesh=mesh), MAPPOConfig(**cfg), num_envs=B,
                 device=dev)
    require(algo.structured_obs, "tensor parallel: N=243 MAPPO did not take the structured path")
    g.manual_seed(1)
    out["mappo_n243"] = _dp_train(algo, mesh, g, iters, "tensor parallel MAPPO N=243")
    del algo
    torch.cuda.empty_cache()
    B, iters = TP_RMAPPO
    algo = make_algo("rmappo", gt.make_env("formation_hd_env", num_agents=3), B, device=dev, mesh=mesh)
    g.manual_seed(3)
    out["rmappo"] = _dp_train(algo, mesh, g, iters, "tensor parallel RMAPPO")
    return out


def tp_world_rank(mesh, out_dir):
    """A rank of the tensor-parallel phase's gloo world."""
    from gym_formation_tpu_torch.parallel import tensor

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.save(tp_programs(mesh, dev), os.path.join(out_dir, f"rank{tensor.rank(mesh)}.pt"))


def _tp_replicated_equal(ranks, key):
    """Both ranks hold the same uncut leaves, bit for bit."""
    a, b = ranks[0][key], ranks[1][key]
    return all(torch.equal(x, y) for x, y, cut in zip(a["local"], b["local"], a["cut"], strict=True) if not cut)


def _mb(n):
    return f"{n / 1e6:.1f} MB"


def phase_tensor_parallel(dev, card, dp_ref):
    """The four paths in a world of 2 processes (gloo) on the one card on
    the mesh {'data': 1, 'model': 2}, against this process's runs (phase
    40's ``dp_ref`` where it has them)."""
    import shutil

    from gym_formation_tpu_torch import parallel

    t_phase = time.perf_counter()
    ref = dict(tp_programs(None, dev, dp_ref), mappo_n3=dp_ref["mappo_n3"], maddpg=dp_ref["maddpg"])
    torch.cuda.empty_cache()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    t0 = time.perf_counter()
    parallel.spawn(tp_world_rank, 2, (TP_DIR,), backend="gloo", device_type="cuda", tp=2)
    world_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(TP_DIR, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    w = ranks[0]

    def report(key, label, steps, launches):
        res = w[key]
        held, whole = res["held"], res["held_whole"]
        for r, rank in enumerate(ranks):
            require(rank[key]["held"] == held, f"tensor parallel {label}: rank {r} holds {rank[key]['held']}")
        require(held["params"] < whole["params"] and held["moments"] < whole["moments"],
                f"tensor parallel {label}: nothing cut ({held} of {whole})")
        require(_tp_replicated_equal(ranks, key), f"tensor parallel {label}: the ranks' replicated leaves differ")
        iters = len(res["walls"])
        calls = res["model_calls"]
        print(f"tensor parallel {label}: held a rank params {_mb(held['params'])} + moments "
              f"{_mb(held['moments'])} = {_mb(held['params'] + held['moments'])} against "
              f"{_mb(whole['params'] + whole['moments'])} whole; launches a rank {launches}; model axis "
              f"all_gather {calls['model_all_gather'] / iters:.1f} and all_reduce "
              f"{calls['model_all_reduce'] / iters:.1f} calls, {res['model_ms'] / iters:.3f} ms an iteration "
              f"(CUDA events, rank 0); data axis all_reduce {res['all_reduce'] / iters:.1f} calls; training "
              f"env-steps/s one process {_dp_rate(ref[key], steps):.1f}, TP=2 on one card (gloo) "
              f"{_dp_rate(res, steps):.1f} ({card})")

    # MAPPO N=3 fused: K5 on gathered weights, K9's gradients cut back
    B, iters = DP_MAPPO_N3
    err = _dp_close(w["mappo_n3"]["params"][-1], ref["mappo_n3"]["params"][-1], "tensor parallel MAPPO N=3")
    grel = _dp_grad_close(w["mappo_n3"]["first_grad"], ref["mappo_n3"]["first_grad"],
                          "tensor parallel MAPPO N=3 first gradient")
    for r, rank in enumerate(ranks):
        c = rank["mappo_n3"]["counts"]
        require(c["fused_collect"] == iters and c["fused_ppo_grad"] == iters * 10,
                f"tensor parallel MAPPO N=3 rank {r}: launches {c}")
    c = w["mappo_n3"]["counts"]
    print(f"tensor parallel MAPPO N=3 B={B} fused, {iters} iterations: parameters against the unsharded run max "
          f"abs err {err:.3e} (rtol {DP_GATE['rtol']}, atol {DP_GATE['atol']}), the first step's gradient's "
          f"{grel:.3e} of its largest entry")
    report("mappo_n3", f"MAPPO N=3 B={B} fused", 25 * B, f"{c['fused_collect']} K5, {c['fused_ppo_grad']} K9")

    # MAPPO N=243 structured: K1 and K2 once an env step; the critic's
    # first kernel cut.  Held through the step's gradient, as phase 40
    B, iters, _ = TP_MAPPO_N243
    grel = _dp_grad_close(w["mappo_n243"]["first_grad"], ref["mappo_n243"]["first_grad"],
                          "tensor parallel MAPPO N=243 gradient")
    err, over = _dp_param_spread(w["mappo_n243"]["params"][-1], ref["mappo_n243"]["params"][-1])
    require(err <= 2 * 7e-4 * iters, f"tensor parallel MAPPO N=243: parameters apart by {err:.3e}, more than "
            f"sign flips of {iters} Adam step give")
    for r, rank in enumerate(ranks):
        c = rank["mappo_n243"]["counts"]
        require(c["pairforce_sym"] == iters * 25 and c["reward_sym"] == iters * 25 and c["fused_collect"] == 0,
                f"tensor parallel MAPPO N=243 rank {r}: launches {c}")
    c = w["mappo_n243"]["counts"]
    print(f"tensor parallel MAPPO N=243 structured B={B}, {iters} iteration of 1 epoch: the step's gradient within "
          f"rtol 5e-3 (largest error {grel:.3e} of its largest entry); parameters max abs err {err:.3e}, "
          f"{over:.3e} of them outside rtol 5e-3 atol 5e-5")
    report("mappo_n243", f"MAPPO N=243 structured B={B}", 25 * B, f"{c['pairforce_sym']} K1, {c['reward_sym']} K2")

    # RMAPPO N=3 and MADDPG N=3: K1 and K2 once an env step
    for key, label, (B, iters), steps_per_iter in (("rmappo", "RMAPPO N=3", TP_RMAPPO, 25),
                                                   ("maddpg", "MADDPG N=3", DP_MADDPG, 32)):
        err = _dp_close(w[key]["params"][-1], ref[key]["params"][-1], f"tensor parallel {label}")
        for r, rank in enumerate(ranks):
            c = rank[key]["counts"]
            require(c["pairforce_sym"] == iters * steps_per_iter and c["reward_sym"] == iters * steps_per_iter,
                    f"tensor parallel {label} rank {r}: launches {c}")
        c = w[key]["counts"]
        print(f"tensor parallel {label} B={B}, {iters} iterations: parameters against the unsharded run max abs "
              f"err {err:.3e} (rtol {DP_GATE['rtol']}, atol {DP_GATE['atol']})")
        report(key, f"{label} B={B}", steps_per_iter * B, f"{c['pairforce_sym']} K1, {c['reward_sym']} K2")
    print(f"tensor parallel phase: {time.perf_counter() - t_phase:.1f} s (the world {world_s:.1f} s with its "
          f"processes' start)")


# -- the bench and the graft entry ---------------------------------------------------
BENCH_TIMEOUT = 600  # seconds for the no-args bench in its own process (about 1 minute expected)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "windows", "min", "max"]


def bench_row3_k1(dev, args):
    """K1 against its plain version at the bench's row 3 (basic_formation_env,
    N=3, agents of size 0.1, B=4096): the row's own first positions (its
    seed-0 reset), pairs in exact contact (0.2 apart), in deep penetration
    (0.05 apart) and at zero distance, and all agents in contact; atol =
    rtol = 1e-3 and two launches bit for bit, as phase 3.  Returns the
    largest error."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.core.physics import _collide_subset
    from gym_formation_tpu_torch.ops.kernels import pairforce_sym as k1

    env = gt.make_env(args.scenario, num_agents=args.num_agents)
    lo, hi, _, cfg = _collide_subset(env.cfg)
    p = k1._params(cfg)
    require(abs(p["dmin"] - 0.2) < 1e-12, f"bench row 3: K1's contact distance {p['dmin']}, want 2 x 0.1")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    own = env.reset_state(g, args.num_envs).pos[:, lo:hi].contiguous()
    B, n = own.shape[:2]
    rng = np.random.RandomState(42)
    contact = own.cpu().numpy().astype(np.float64)
    third = B // 3
    contact[:third, 1] = contact[:third, 0] + [0.2, 0.0]  # exact contact
    contact[third:2 * third, 1] = contact[third:2 * third, 0] + [0.0, 0.05]  # deep penetration
    contact[2 * third:, 2] = contact[2 * third:, 1]  # zero distance
    err = 0.0
    for label, pos in (("the row's reset", own), ("contact", contact),
                       ("all in contact", rng.uniform(-0.05, 0.05, (B, n, 2)))):
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev).contiguous()
        got = k1.collision_forces_sym(pos, cfg)
        want = k1.collision_forces_sym_plain(pos, **p)
        again = k1.collision_forces_sym(pos, cfg)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"K1 bench row 3 {label}: non-finite forces")
        err = max(err, check_close(got, want, 1e-3, 1e-3, f"K1 bench row 3 {label}"))
        require(torch.equal(got, again), f"K1 bench row 3 {label}: two launches differ")
        if label != "the row's reset":
            require(float(want.abs().max()) > 0, f"K1 bench row 3 {label}: no contact force")
        print(f"K1 bench row 3 ({args.scenario} N={n}, size 0.1) {label} B={B}: max abs err "
              f"{max_err(got, want):.3e} (atol=rtol=1e-3), two launches bit for bit")
    return err


def phase_bench(dev, kmods, card):
    """Phase 42: ``python -m gym_formation_tpu_torch.bench`` with no
    arguments in its own process (three JSON lines in SUITE order, emit's
    keys, the metrics the SUITE's rows compose, finite rates > 0), and
    its row 2 under ``--mesh 1`` (an nccl world of one rank); each
    SUITE row once more through ``bench.run`` in this process at 2 chunks a
    window and one window, its launches counted (row 1 K4 once a chunk;
    row 2 K3 once a step and the masked K2 once a step and once a chunk,
    never K1 nor the PyTorch BFS; row 3 K1 once a step); ``--fused on`` at
    n=5 refused; K1 against its plain version at row 3's configuration
    (:func:`bench_row3_k1`); ``graft_entry.entry()``'s forward on the card
    against the CPU.  Returns the rows' rates and launches and K1's
    largest error."""
    import contextlib
    import io

    from gym_formation_tpu_torch import bench
    from gym_formation_tpu_torch.graft_entry import entry
    from gym_formation_tpu_torch.models import bfs

    defaults = bench.build_parser().parse_args([])
    suite = bench.rows(defaults, [])
    want = [bench.metric_of(a, bench.uses_k4(a, dev)) for a in suite]
    stdout, wall = run_entry(["gym_formation_tpu_torch.bench"], "bench", timeout=BENCH_TIMEOUT)
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    require([line.get("metric") for line in lines] == want, f"bench: lines {lines}, want the metrics {want}")
    for line in lines:
        require(list(line) == BENCH_KEYS, f"bench: keys {list(line)}")
        vals = [line[k] for k in ("value", "vs_baseline", "min", "max")]
        require(all(np.isfinite(v) and v > 0 for v in vals) and line["windows"] == defaults.windows,
                f"bench: {line}")
    print(f"bench, no arguments: {len(lines)} rows in {wall:.2f} s (process and kernel load included); {card}")
    # the --mesh branch: an nccl world of 1 on the sharded fused route
    mesh_args = ["--mesh", "1", "--num-agents", "243", "--policy", "bfs_state", "--iters", "2", "--windows", "1"]
    stdout, wall = run_entry(["gym_formation_tpu_torch.bench", *mesh_args], "bench --mesh 1", timeout=BENCH_TIMEOUT)
    mesh_lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    require(len(mesh_lines) == 1 and mesh_lines[0]["metric"] == want[1] and mesh_lines[0]["value"] > 0,
            f"bench --mesh 1: {mesh_lines}")

    T = defaults.chunk
    out = {"rates": [line["value"] for line in lines], "launches": []}
    for i, a in enumerate(suite):
        a.iters, a.windows = 2, 1
        chunks = 1 + a.windows * (max(a.iters, 64) if i == 0 else a.iters)
        expand = []
        orig = bfs._expand
        bfs._expand = lambda *args, **kw: expand.append(1) or orig(*args, **kw)
        torch.cuda.synchronize()
        reset_counts(*kmods)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                res = bench.run(None, a)
        finally:
            bfs._expand = orig
        counts = launch_counts(kmods)
        counts["bfs_expand"] = len(expand)
        print(f"bench row {i + 1} in this process, {chunks} chunks of {T} steps: launches {counts}; "
              f"{buf.getvalue().strip()}")
        require(all(np.isfinite(res["sums"])) and all(r > 0 for r in res["rates"]), f"bench row {i + 1}: {res}")
        if i == 0:
            want_counts = {"fused_rollout": chunks}
        elif i == 1:
            want_counts = {"fused_step": chunks * T, "reward_sym": chunks * (T + 1), "step_reset": chunks * T,
                           "pairforce_sym": 0, "bfs_expand": 0}
        else:
            want_counts = {"pairforce_sym": chunks * T, "fused_step": 0, "fused_rollout": 0, "step_reset": 0}
        for name, n in want_counts.items():
            require(counts[name] == n, f"bench row {i + 1}: {name} {counts[name]} launches, want {n}")
        if i == 0:
            require(sum(counts.values()) == chunks, f"bench row 1 launched other kernels: {counts}")
        out["launches"].append(counts)

    refused = bench.build_parser().parse_args(["--fused", "on", "--num-agents", "5", "--num-envs", "512",
                                               "--chunk", "2", "--iters", "1", "--windows", "1"])
    reset_counts(*kmods)
    try:
        bench.run(None, refused)
        raised = None
    except ValueError as e:
        raised = str(e)
    require(raised is not None and "K4 is built for n" in raised, f"--fused on at n=5 on the card: {raised}")
    require(sum(launch_counts(kmods).values()) == 0, "--fused on at n=5 launched a kernel")
    print(f"bench --fused on --num-agents 5: refused ({raised})")
    out["k1_err"] = bench_row3_k1(dev, suite[2])

    fn, (params, obs) = entry()
    require(obs.is_cuda and all(p.is_cuda for v in params.values() for p in v.values()), "entry: not on the card")
    with torch.no_grad():
        mean, value = fn(params, obs)
        cmean, cvalue = fn({k: {m: p.cpu() for m, p in v.items()} for k, v in params.items()}, obs.cpu())
    require(tuple(mean.shape) == (64, 9, 2) and tuple(value.shape) == (64,),
            f"entry: shapes {tuple(mean.shape)}, {tuple(value.shape)}")
    e_mean = check_close(mean.cpu(), cmean, 1e-5, 1e-5, "entry mean, card against CPU")
    e_value = check_close(value.cpu(), cvalue, 1e-5, 1e-5, "entry value, card against CPU")
    print(f"entry ok: {tuple(mean.shape)}, {tuple(value.shape)}; card against CPU max abs err mean "
          f"{e_mean:.3e}, value {e_value:.3e}")
    return out


HOLD_ENVS, HOLD_ITERS, HOLD_SEED = 1024, 80, 1
# runs/torch_mappo_n3_fused_s{1,2,3} at 2,048,000 steps (the window rule of
# tools/learning_curves.py): -2.91654, -2.90524, -2.87255; min and max
# widened by 0.25 x |-2.27 - (-5.25)| = 0.745 (the reference's improvement,
# RESULTS.md:683)
HOLD_BAND = (-2.91654 - 0.745, -2.87255 + 0.745)


def phase_learning_hold(dev, kmods):
    """The curve row mappo_n3_fused's route for 80 iterations: K5 once and
    K9 ten times an iteration, nothing else, and the reward of iterations
    76-80 in band."""
    algo = mappo_n3(dev, HOLD_ENVS, fused_update=True)
    require(algo.fused_collect, "learning hold: the auto gate did not turn fused_collect on")
    g = torch.Generator(device=dev)
    g.manual_seed(HOLD_SEED)
    ts, es, obs = algo.init(g)
    torch.cuda.synchronize()
    reset_counts(*kmods)
    t0 = time.perf_counter()
    rewards = []
    for _ in range(HOLD_ITERS):
        ts, es, obs, m = algo.train_step(ts, es, obs, g)
        rewards.append(m["mean_step_reward"])
    rewards = torch.stack(rewards).cpu().numpy()
    wall = time.perf_counter() - t0
    counts = launch_counts(kmods)
    print(f"learning hold: MAPPO N=3 B={HOLD_ENVS} fused, {HOLD_ITERS} iterations in {wall:.2f} s, launches {counts}")
    require(counts["fused_collect"] == HOLD_ITERS, "learning hold: K5 not once an iteration")
    require(counts["fused_ppo_grad"] == HOLD_ITERS * algo.cfg.ppo_epochs, "learning hold: K9 not once an epoch")
    for name, n in counts.items():
        require(name in ("fused_collect", "fused_ppo_grad") or n == 0, f"learning hold: {name} launched")
    require(bool(np.isfinite(rewards).all()), "learning hold: non-finite rewards")
    tail = float(rewards[HOLD_ITERS - 5:].mean())
    lo, hi = HOLD_BAND
    require(lo <= tail <= hi, f"learning hold: mean_step_reward of iterations 76-80 {tail:.4f} outside "
            f"[{lo:.4f}, {hi:.4f}]")
    print(f"learning hold: mean_step_reward {rewards[0]:.4f} -> iterations 76-80 {tail:.4f}, inside "
          f"[{lo:.4f}, {hi:.4f}]")
    return dict(counts=counts, tail=tail, wall=wall)


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
    from gym_formation_tpu_torch.ops.kernels import fused_rollout as k4
    from gym_formation_tpu_torch.ops.kernels import fused_step as k3
    from gym_formation_tpu_torch.ops.kernels import pairforce_sym as k1
    from gym_formation_tpu_torch.ops.kernels import reward_sym as k2
    from gym_formation_tpu_torch.ops.kernels import fused_collect as k5
    from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9
    from gym_formation_tpu_torch.ops.kernels import pairforce as k6
    from gym_formation_tpu_torch.ops.kernels import reward as k7
    from gym_formation_tpu_torch.ops.kernels import pairforce_cull as k8
    from gym_formation_tpu_torch.ops.kernels import step_reset as glue

    kmods = (k1, k2, k3, k4, k5, k9, k6, k7, k8, glue)
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
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rng = np.random.RandomState(0)

    # -- 3. K1 -----------------------------------------------------------
    phase("K1 pairforce_sym vs plain")
    cfg = make_world_cfg(NUM_AGENTS, 0, agent_size=0.03)  # the hd colliding subset
    p = k1._params(cfg)
    k1_err = 0.0
    contact = rng.uniform(-0.5, 0.5, (5, NUM_AGENTS, 2)).astype(np.float32)
    contact[:, 1] = contact[:, 0] + np.float32([0.04, 0.0])  # exact contact, deep penetration, zero distance
    contact[:, 2] = contact[:, 0] + np.float32([0.0, 0.0601])
    contact[:, 3] = contact[:, 4]
    # every pair in contact: a pair the sweep skipped or took twice would show
    all_contact = rng.uniform(-0.02, 0.02, (64, NUM_AGENTS, 2)).astype(np.float32)
    for label, pos in (("random", rng.uniform(-0.5, 0.5, (512, NUM_AGENTS, 2))),
                       ("random", rng.uniform(-0.5, 0.5, (NUM_ENVS, NUM_AGENTS, 2))),
                       ("contact", contact), ("all in contact", all_contact)):
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        B = pos.shape[0]
        got = k1.collision_forces_sym(pos, cfg)
        want = k1.collision_forces_sym_plain(pos, **p)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"K1 {label} B={B}: non-finite forces")
        k1_err = max(k1_err, check_close(got, want, 1e-3, 1e-3, f"K1 {label} B={B}"))
        print(f"K1 {label} B={B} E={NUM_AGENTS}: max abs err {max_err(got, want):.3e} (atol=rtol=1e-3)")
    again = k1.collision_forces_sym(pos, cfg)
    require(torch.equal(got, again), "K1: two launches differ")

    # -- 4. K2 -----------------------------------------------------------
    phase("K2 reward_sym vs plain")
    k2_err = 0.0
    for B, scale in ((512, 1.0), (512, 0.05), (NUM_ENVS, 0.05)):
        apos = torch.as_tensor(rng.uniform(-1, 1, (B, NUM_AGENTS, 2)) * scale, dtype=torch.float32, device=dev)
        ishape = torch.as_tensor(rng.uniform(-1, 1, (B, NUM_AGENTS, 2)), dtype=torch.float32, device=dev)
        ishape = (ishape - ishape.mean(1, keepdim=True)).contiguous()
        h, nc = k2.hd_reward_stats_sym(apos, ishape, thresh=THRESH)
        h_p, nc_p = k2.hd_reward_stats_sym_plain(apos, ishape, thresh=THRESH)
        torch.cuda.synchronize()
        k2_err = max(k2_err, check_close(h, h_p, 1e-5, 0.0, f"K2 haus B={B} scale={scale}"))
        require(torch.equal(nc, nc_p), f"K2 counts B={B} scale={scale}: kernel and plain differ")
        if scale < 1.0:
            require(int(nc.sum()) > 0, "K2: the squeezed fixture has no collisions")
        print(f"K2 B={B} N={NUM_AGENTS} scale={scale}: haus max abs err {max_err(h, h_p):.3e} "
              f"(atol 1e-5), counts equal ({int(nc.sum())} collisions)")
    # the masked form the fused rollout launches every step
    mask = torch.as_tensor(rng.uniform(0, 1, NUM_ENVS) < 0.1, device=dev)
    fb = (torch.full((NUM_ENVS,), -1.0, device=dev), torch.full((NUM_ENVS, NUM_AGENTS), -2.0, device=dev))
    h, nc = k2.hd_reward_stats_sym(apos, ishape, thresh=THRESH, mask=mask, fallback=fb)
    h_p, nc_p = k2.hd_reward_stats_sym_plain(apos, ishape, thresh=THRESH, mask=mask, fallback=fb)
    k2_err = max(k2_err, check_close(h, h_p, 1e-5, 0.0, "K2 masked haus"))
    require(torch.equal(nc, nc_p), "K2 masked counts: kernel and plain differ")
    print(f"K2 masked ({int(mask.sum())} of {NUM_ENVS} envs): haus max abs err {max_err(h, h_p):.3e}, counts equal")

    # -- 5. step path ----------------------------------------------------
    phase("step path")
    venv = gt.make_vec_env("formation_hd_env", num_envs=NUM_ENVS, num_agents=NUM_AGENTS,
                           device=dev, seed=0)
    scen = venv.env.scenario
    policy = lambda s, g: gt.bfs_actions_from_state(gt.ezpolicy_batched, scen, s, 3)
    state = venv.reset_state()
    torch.cuda.synchronize()
    reset_counts(*kmods)
    t0 = time.perf_counter()
    state, rsum = gt.rollout_statepolicy_rewardsum(venv.env, policy, state, venv.generator, STEPS)
    rsum_host = rsum.cpu()
    first_run_s = time.perf_counter() - t0
    step_launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kmods}
    print(f"{STEPS} steps at N={NUM_AGENTS} B={NUM_ENVS}: {first_run_s:.2f} s, launches {step_launches}")
    for name in ("pairforce_sym", "reward_sym"):
        require(step_launches[name] == STEPS, f"{name}: {step_launches[name]} launches in {STEPS} steps of the step path")
    for name in ("pairforce", "reward", "pairforce_cull"):
        require(step_launches[name] == 0, f"the step path launched {name} under the default selectors")
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
        st = injected_state(n, B, n)
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

    def step_window():
        nonlocal state
        state, rs = gt.rollout_statepolicy_rewardsum(venv.env, policy, state, venv.generator, WINDOW)
        return rs

    step_rate = throughput(step_window, NUM_ENVS, WINDOW, f"step path N={NUM_AGENTS} B={NUM_ENVS}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Kernel against plain at the path's shapes.
    pos = scen.agent_pos(state).contiguous()
    k1_ms, k1_plain_ms = time_pair(lambda: k1.collision_forces_sym(pos, cfg),
                                   lambda: k1.collision_forces_sym_plain(pos, **p))
    ishape = state.ideal_shape.contiguous()
    k2_ms, k2_plain_ms = time_pair(lambda: k2.hd_reward_stats_sym(pos, ishape, thresh=THRESH),
                                   lambda: k2.hd_reward_stats_sym_plain(pos, ishape, thresh=THRESH))
    print(f"K1 B={NUM_ENVS}: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms; special-function bound "
          f"{sfu_ms(NUM_ENVS * NUM_AGENTS * (NUM_AGENTS - 1)):.4f} ms")
    print(f"K2 B={NUM_ENVS}: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms")

    # -- 6. K3 -----------------------------------------------------------
    phase("K3 fused_step vs plain")
    k3_err = 0.0

    def k3_inputs(B, squeeze, seed):
        r = np.random.RandomState(seed)
        f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
        ish = r.uniform(-1, 1, (B, NUM_AGENTS, 2))
        return (f(r.uniform(-1, 1, (B, NUM_AGENTS, 2)) * squeeze), f(r.uniform(-0.5, 0.5, (B, NUM_AGENTS, 2))),
                f(r.uniform(-5, 5, (B, NUM_AGENTS, 2))), f(ish - ish.mean(1, keepdims=True)),
                f(r.uniform(-1, 1, (B, 2))))

    for B, squeeze in ((512, 1.0), (NUM_ENVS, 1.0), (512, 0.1)):
        apos, avel, aforce, ish, ivel = k3_inputs(B, squeeze, B + int(squeeze * 10))
        for stats in ("pre", "post"):
            for pol_name, force, kw in (("external", aforce, {}),
                                        ("bfs_ez", None, dict(bfs_L=5, ideal_vel=ivel, act_scale=5.0))):
                args = (apos, avel, force, ish, cfg)
                got = k3.fused_hd_step(*args, thresh=THRESH, stats=stats, **kw)
                want = k3.fused_hd_step_plain(*args, thresh=THRESH, stats=stats, **kw)
                what = f"K3 B={B} squeeze={squeeze} {stats} {pol_name}"
                errs = (check_close(got[0], want[0], 2e-4, 1e-4, what + " pos"),
                        check_close(got[1], want[1], 2e-3, 1e-4, what + " vel"),
                        check_close(got[2], want[2], 1e-5, 0.0, what + " haus"))
                require(torch.equal(got[3], want[3]), f"{what}: counts differ")
                if squeeze < 1.0:
                    require(int(got[3].sum()) > 0, f"{what}: the squeezed fixture has no collisions")
                k3_err = max(k3_err, *errs)
                print(f"{what}: pos {errs[0]:.2e} vel {errs[1]:.2e} haus {errs[2]:.2e}, "
                      f"counts equal ({int(got[3].sum())} collisions)")

    # -- 7. K4 -----------------------------------------------------------
    phase("K4 fused_rollout vs plain")
    n3, ep_len, k4_T = 3, 100, 120
    v3 = gt.make_vec_env("formation_hd_env", num_envs=NUM_ENVS, num_agents=n3, device=dev, seed=3)
    v9 = gt.make_vec_env("formation_hd_env", num_envs=NUM_ENVS, num_agents=9, device=dev, seed=3)
    k4_err = 0.0
    # (n, B, steps, ep_len): the batch of the N=3 path at each instantiated
    # n, and a ragged B whose last warp's groups are partly empty; the
    # episode counters spread over [0, ep_len) so that every env resets
    for n, B4, T4, ep4 in ((n3, NUM_ENVS, k4_T, ep_len), (4, NUM_ENVS, 50, 40), (9, NUM_ENVS, 50, 40),
                           (3, 37, 25, 10), (4, 37, 25, 10), (9, 37, 25, 10)):
        if B4 == NUM_ENVS and n in (3, 9):
            soa = k4.state_to_soa((v3 if n == 3 else v9).reset_state())
        else:
            soa = k4.state_to_soa(gt.make_vec_env("formation_hd_env", num_envs=B4, num_agents=n, device=dev,
                                                  seed=n).reset_state())
        trng = rng if (n, B4) == (n3, NUM_ENVS) else np.random.RandomState(n * B4)  # the later phases' draws stay
        soa = soa._replace(t=torch.as_tensor(trng.randint(0, ep4, (1, B4)), dtype=torch.int32, device=dev))
        kw4 = dict(length=T4, ep_len=ep4, n=n)
        s_k, r_k = k4.fused_rollout_hd(soa, 5, **kw4)
        s_p, r_p = k4.fused_rollout_hd_plain(soa, 5, **kw4)
        # tolerances of tests/test_fused_rollout.py (state 3e-4 at n=9), and
        # the design's claim: every output bit for bit
        tol = 1e-5 if n < 9 else 3e-4
        err = check_close(r_k, r_p, 2e-3, 5e-6, f"K4 n={n} B={B4} reward sum")
        for name in ("ap", "av", "ishape", "ivel"):
            err = max(err, check_close(getattr(s_k, name), getattr(s_p, name), tol, 0.0, f"K4 n={n} {name}"))
        require(torch.equal(s_k.t, s_p.t), f"K4 n={n} B={B4}: episode counters differ")
        require(bool((s_k.t < T4).all()), f"K4 n={n} B={B4}: not every env reset")
        same = torch.equal(r_k, r_p) and all(torch.equal(x, y) for x, y in zip(s_k, s_p))
        require(same, f"K4 n={n} B={B4}: not bit for bit with the plain version (max abs err {err:.3e})")
        k4_err = max(k4_err, err)
        print(f"K4 n={n} B={B4} T={T4} ep_len={ep4}: max abs err {err:.3e} (state atol {tol:g}; reward atol "
              f"2e-3 rtol 5e-6), bit for bit, counters equal, every env reset")

    # -- 8. fused path (N=243) --------------------------------------------
    phase("fused path")
    fenv = gt.make_vec_env("formation_hd_env", num_envs=NUM_ENVS, num_agents=NUM_AGENTS,
                           device=dev, seed=0)
    fstate = fenv.reset_state()
    torch.cuda.synchronize()
    reset_counts(*kmods)
    t0 = time.perf_counter()
    fstate, frew = gt.rollout_statepolicy_fused(fenv.env, None, fstate, fenv.generator, STEPS,
                                                stats="pre", policy="bfs_ez")
    frew_host = frew.cpu()
    first_run_s = time.perf_counter() - t0
    fused_launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kmods}
    print(f"{STEPS} fused steps at N={NUM_AGENTS} B={NUM_ENVS}: {first_run_s:.2f} s, launches {fused_launches}")
    require(fused_launches["fused_step"] == STEPS, f"fused_step: {fused_launches['fused_step']} launches in {STEPS} steps")
    require(fused_launches["reward_sym"] == STEPS + 1,
            f"reward_sym: {fused_launches['reward_sym']} launches in {STEPS} fused steps (want one a step and one to finalize)")
    require(fused_launches["step_reset"] == STEPS,
            f"step_reset: {fused_launches['step_reset']} launches in {STEPS} fused steps")
    require(fused_launches["pairforce_sym"] == 0, "the fused path launched K1")
    require(tuple(frew_host.shape) == (STEPS, NUM_ENVS), f"fused rewards shape {tuple(frew_host.shape)}")
    require(bool(torch.isfinite(frew_host).all()), "non-finite fused rewards")
    require(bool(torch.isfinite(fstate.pos).all()) and bool(torch.isfinite(fstate.vel).all()),
            "non-finite fused state")
    t_host = fstate.t.cpu()
    require(bool(torch.all(t_host == STEPS - fenv.env.world_length)),
            f"fused episode counters after the auto-reset: {t_host.unique().tolist()}")
    print(f"fused reward per step and env: mean {float(frew_host.mean()):.4f} "
          f"min {float(frew_host.min()):.4f} max {float(frew_host.max()):.4f}")

    # card against the CPU plain path, within the first episode (the card's
    # and the CPU's generators draw different resets)
    for n, B, T, stats in ((27, 16, 8, "pre"), (27, 16, 8, "post"), (NUM_AGENTS, 4, 3, "pre")):
        small = gt.make_env("formation_hd_env", num_agents=n)
        st = injected_state(n, B, 100 + n)
        out = {}
        for d in ("cuda", "cpu"):
            g = torch.Generator(device=d)
            fin, rew = gt.rollout_statepolicy_fused(small, None, gt.state_from_numpy(st, device=d), g, T,
                                                    stats=stats, policy="bfs_ez")
            out[d] = (fin.pos.cpu(), fin.vel.cpu(), rew.cpu())
        (cp, cv, cr), (pp, pv, pr) = out["cuda"], out["cpu"]
        # tolerances of tests/test_fused_rollout_hd.py
        check_close(cp, pp, 1e-3, 1e-4, f"fused N={n} {stats} pos")
        check_close(cv, pv, 1e-3, 1e-4, f"fused N={n} {stats} vel")
        check_close(cr, pr, 5e-3, 1e-4, f"fused N={n} {stats} reward")
        print(f"fused N={n} B={B} T={T} {stats}: card vs CPU plain agree "
              f"(pos {max_err(cp, pp):.2e}, vel {max_err(cv, pv):.2e}, reward {max_err(cr, pr):.2e})")

    def fused_window():
        nonlocal fstate
        fstate, r = gt.rollout_statepolicy_fused(fenv.env, None, fstate, fenv.generator, WINDOW,
                                                 stats="pre", policy="bfs_ez")
        return r.sum(0)

    fused_rate = throughput(fused_window, NUM_ENVS, WINDOW, f"fused path N={NUM_AGENTS} B={NUM_ENVS}")
    print(f"fused path / step path env-steps/s: {fused_rate / step_rate:.3f}")

    # K3 against its plain version at the path's shapes; the masked K2 of a
    # step without resets against an unconditional recompute and select.
    fpos = fstate.pos[:, :NUM_AGENTS]
    fvel = fstate.vel[:, :NUM_AGENTS]
    fish = fstate.ideal_shape
    k3kw = dict(thresh=THRESH, stats="pre", bfs_L=5, ideal_vel=fstate.ideal_vel, act_scale=5.0)
    k3_ms, k3_plain_ms = time_pair(lambda: k3.fused_hd_step(fpos, fvel, None, fish, cfg, **k3kw),
                                   lambda: k3.fused_hd_step_plain(fpos, fvel, None, fish, cfg, **k3kw))
    print(f"K3 B={NUM_ENVS} bfs_ez pre: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms")
    # K3's time split on the same state, in turns: the in-kernel BFS's share
    # is bfs_ez - external; K1 and K2 alone do K3's pairs and statistics
    fposc = fpos.contiguous()
    fact = torch.as_tensor(np.random.RandomState(8).uniform(-5, 5, (NUM_ENVS, NUM_AGENTS, 2)), dtype=torch.float32, device=dev)
    split = {
        "K3 external": lambda: k3.fused_hd_step(fpos, fvel, fact, fish, cfg, thresh=THRESH, stats="pre"),
        "K3 bfs_ez": lambda: k3.fused_hd_step(fpos, fvel, None, fish, cfg, **k3kw),
        "K1": lambda: k1.collision_forces_sym(fposc, cfg),
        "K2": lambda: k2.hd_reward_stats_sym(fposc, fish, thresh=THRESH),
    }
    split_ms = {name: [] for name in split}
    for order in (list(split), list(split)[::-1]):
        for name in order:
            split_ms[name].append(time_ms(split[name], 20))
    print("K3 split at the fused path's state (ms, two turns): " + ", ".join(
        f"{name} {sum(v) / 2:.4f}" for name, v in split_ms.items()) + f"; K3's special-function bound "
        f"{sfu_ms(NUM_ENVS * NUM_AGENTS * (NUM_AGENTS - 1)):.4f} ms")
    h_in, nc_in = k3.fused_hd_step(fpos, fvel, None, fish, cfg, **k3kw)[2:]
    no_reset = torch.zeros(NUM_ENVS, dtype=torch.bool, device=dev)
    masked_ms = time_ms(lambda: k2.hd_reward_stats_sym(fposc, fish, thresh=THRESH, mask=no_reset,
                                                       fallback=(h_in, nc_in)), 20)

    def unconditional():
        h2, nc2 = k2.hd_reward_stats_sym(fposc, fish, thresh=THRESH)
        return torch.where(no_reset, h2, h_in), torch.where(no_reset[:, None], nc2, nc_in)

    uncond_ms = time_ms(unconditional, 20)
    draw_ms = time_ms(lambda: fenv.env.reset_state(fenv.generator, NUM_ENVS), 20)
    print(f"reset-boundary recompute on a step without resets: masked K2 {masked_ms:.4f} ms, "
          f"unconditional K2 + select {uncond_ms:.4f} ms")
    print(f"auto-reset draw (reset_state) {draw_ms:.4f} ms = {draw_ms / (NUM_ENVS / fused_rate * 1e3):.3f} "
          f"of the fused step wall")

    # The step glue against its plain version at the path's shapes: the
    # path's state, K3's outputs on it, and the episode counters spread so
    # that the envs at world_length - 1 reset
    wl = fenv.env.world_length
    npos, nvel = (x.contiguous() for x in k3.fused_hd_step(fpos, fvel, None, fish, cfg, **k3kw)[:2])
    g_glue = torch.Generator(device=dev)
    g_glue.manual_seed(5)
    draws = tuple(torch.rand(shape, generator=g_glue, device=dev)
                  for shape in ((NUM_ENVS, NUM_AGENTS, 2), (NUM_ENVS, NUM_AGENTS, 2), (NUM_ENVS, 2)))
    glue_args = (fstate.pos.contiguous(), fstate.vel.contiguous(), fstate.ideal_shape.contiguous(),
                 fstate.ideal_vel.contiguous(), torch.arange(NUM_ENVS, dtype=torch.int32, device=dev) % wl,
                 npos, nvel, *draws)
    glue_kw = dict(row0=0, world_length=wl)
    got = glue.step_reset(*glue_args, **glue_kw)
    want = glue.step_reset_plain(*glue_args, **glue_kw)
    glue_resets = int(want[6].sum())
    require(0 < glue_resets < NUM_ENVS, f"step_reset: {glue_resets} of {NUM_ENVS} envs reset")
    for i, name in ((1, "vel"), (3, "ideal_vel"), (4, "t"), (6, "done")):
        require(torch.equal(got[i], want[i]), f"step_reset {name}: kernel and plain differ")
    require(torch.equal(got[0][:, :NUM_AGENTS], want[0][:, :NUM_AGENTS]), "step_reset agents: kernel and plain differ")
    glue_err = max(check_close(got[0], want[0], 3e-5, 0.0, "step_reset landmarks"),
                   check_close(got[2], want[2], 3e-5, 0.0, "step_reset shape"),
                   check_close(got[5], want[5], 3e-5, 0.0, "step_reset velterm"))
    glue_ms, glue_plain_ms = time_pair(lambda: glue.step_reset(*glue_args, **glue_kw),
                                       lambda: glue.step_reset_plain(*glue_args, **glue_kw))
    print(f"step_reset B={NUM_ENVS} ({glue_resets} resetting): kernel {glue_ms:.4f} ms, plain {glue_plain_ms:.4f} ms; "
          f"agents, velocities, ideal velocity, counters and done bit for bit, landmarks, shape and velocity term "
          f"max abs err {glue_err:.3e} (atol 3e-5)")

    # -- 9. N=3 path (K4) -------------------------------------------------
    phase("N=3 path")
    soa3 = k4.state_to_soa(v3.reset_state())
    torch.cuda.synchronize()
    reset_counts(*kmods)
    seed = 0
    s3, r3 = k4.fused_rollout_hd(soa3, seed, length=N3_LENGTH, ep_len=ep_len, n=n3)
    r3_host = r3.cpu()
    n3_launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kmods}
    print(f"{N3_LENGTH} steps at n={n3} B={NUM_ENVS}: launches {n3_launches}")
    require(n3_launches["fused_rollout"] == 1, "fused_rollout: not one launch for one call")
    require(bool(torch.isfinite(r3_host).all()), "N=3: non-finite reward sums")
    require(bool(torch.all(s3.t.cpu() == N3_LENGTH % ep_len)), "N=3: episode counters after the resets")
    back = k4.soa_to_state(s3, v3.reset_state())
    require(bool(torch.isfinite(back.pos).all()), "N=3: non-finite state")
    print(f"N=3 reward sum per env over {N3_LENGTH} steps: mean {float(r3_host.mean()):.4f}")

    def n3_window():
        nonlocal s3, seed
        seed += 1
        s3, r = k4.fused_rollout_hd(s3, seed, length=N3_LENGTH, ep_len=ep_len, n=n3)
        return r

    throughput(n3_window, NUM_ENVS, N3_LENGTH, f"N=3 path n={n3} B={NUM_ENVS}")
    k4_ms, k4_plain_ms = time_pair(lambda: k4.fused_rollout_hd(soa3, 1, length=N3_LENGTH, ep_len=ep_len, n=n3),
                                   lambda: k4.fused_rollout_hd_plain(soa3, 1, length=N3_LENGTH, ep_len=ep_len, n=n3),
                                   plain_reps=1)
    soa9 = k4.state_to_soa(v9.reset_state())
    k4n9_ms = time_ms(lambda: k4.fused_rollout_hd(soa9, 1, length=N3_LENGTH, ep_len=ep_len, n=9), 20)
    for n, ms in ((n3, k4_ms), (9, k4n9_ms)):
        floors = k4_floors(NUM_ENVS, N3_LENGTH, n)
        print(f"K4 n={n} B={NUM_ENVS} length {N3_LENGTH}: kernel {ms:.4f} ms"
              + (f", plain {k4_plain_ms:.4f} ms" if n == n3 else "")
              + f"; bound {floors['bound']:.4f} ms ({floors['bound_by']}), no-FMA floor {floors['nofma']:.4f} ms, "
              f"special-function floor {floors['sfu']:.4f} ms")

    # -- 10. K5 ------------------------------------------------------------
    phase("K5 fused_collect vs plain")
    k5_res = phase_k5(dev, rng)

    # -- 11. K9 ------------------------------------------------------------
    phase("K9 fused_ppo_grad vs plain")
    k9_res = phase_k9(dev)

    # -- 12. MAPPO N=3 path ------------------------------------------------
    phase("MAPPO N=3 path")
    n3_train = phase_mappo_n3(dev, kmods)

    # -- 13. MAPPO N=243 structured path -----------------------------------
    phase("MAPPO N=243 structured path")
    phase_mappo_n243(dev, kmods)

    # -- 14. K6 -----------------------------------------------------------
    phase("K6 pairforce vs plain")
    k6_err = phase_k6(dev, rng)

    # -- 15. K7 -----------------------------------------------------------
    phase("K7 reward (row-major) vs plain and K2")
    k7_err = phase_k7(dev, rng)

    # -- 16. K8 -----------------------------------------------------------
    phase("K8 pairforce_cull vs plain and K6")
    k8_err = phase_k8(dev, rng)

    # -- 17. hd_obs path ----------------------------------------------------
    phase("hd_obs path")
    obs_res = phase_hd_obs(dev, kmods)

    # -- 18. selector paths -------------------------------------------------
    phase("selector paths")
    sel = phase_selectors(dev, kmods)

    # -- 19. the other scenarios --------------------------------------------
    phase("other scenarios")
    phase_other_scenarios(dev, kmods)

    # -- 20. K1 and K2 at n=3 -------------------------------------------------
    phase("K1 and K2 at n=3 vs plain")
    n3_errs, n3_times = phase_k1k2_n3(dev, rng)
    k1_err, k2_err = max(k1_err, n3_errs["k1"]), max(k2_err, n3_errs["k2"])

    # -- 21-23. the on-policy family at N=3 -----------------------------------
    onpolicy = {}
    for kind, envs in zip(ONPOLICY_KINDS, (RMAPPO_ENVS, MAPPO_ENVS, MAPPO_ENVS)):
        phase(f"{kind} N=3 path")
        onpolicy[kind] = phase_onpolicy(dev, kmods, kind, envs)

    # -- 24. eval -------------------------------------------------------------
    phase("eval of an RMAPPO checkpoint")
    phase_eval(onpolicy["rmappo"]["learner"])

    # -- 25-28. the feed-forward off-policy zoo at N=3 -------------------------
    zoo = {}
    for title, main_kind, side in (("MADDPG", "maddpg", ("ddpg", "maddpg_discrete", "maddpg_per_ou")),
                                   ("MATD3", "matd3", ("matd3_discrete",)),
                                   ("MASAC", "masac", ("masac_discrete",)),
                                   ("QMIX and VDN", "qmix", ("vdn",))):
        phase(f"{title} N=3 path")
        zoo[main_kind] = phase_offpolicy(dev, kmods, main_kind)
        for kind in side:
            zoo[kind] = phase_offpolicy(dev, kmods, kind, full=False)
            del zoo[kind]["learner"]  # its buffer leaves the card

    # -- 29. eval of off-policy checkpoints -------------------------------------
    phase("eval of a MADDPG and a QMIX checkpoint")
    phase_eval(zoo["maddpg"]["learner"], "maddpg", ())
    phase_eval(zoo["qmix"]["learner"], "qmix", ())

    # -- 30-34. the recurrent off-policy zoo at N=3 ------------------------------
    recurrent = {}
    for name in RECURRENT:
        phase(f"{name} N=3 path")
        recurrent[name] = phase_recurrent(dev, kmods, name)
        if name not in ("rmaddpg", "rqmix"):
            del recurrent[name]["learner"]  # its buffer leaves the card

    # -- 35. eval of recurrent checkpoints ---------------------------------------
    phase("eval of an RMADDPG and an RQMIX checkpoint")
    episode = ("--episode-length", str(ZOO_EP_LEN))
    phase_eval(recurrent["rmaddpg"]["learner"], "rmaddpg", episode)
    phase_eval(recurrent["rqmix"]["learner"], "rqmix", episode)

    # -- 36. the imperative surface ---------------------------------------------
    phase("GymMultiAgentEnv, DictAgentEnv and the renderer on the card")
    surface = phase_wrappers(dev, kmods)

    # -- 37. the demo -------------------------------------------------------------
    phase("demo N=243 with --gif")
    phase_demo()

    # -- 38. eval with frames -------------------------------------------------------
    phase("eval --gif --per-agent-view of an RMAPPO checkpoint")
    gif = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_eval.gif")
    stdout = phase_eval(onpolicy["rmappo"]["learner"], "rmappo",
                        ("--episode-length", "25", "--gif", gif, "--per-agent-view"), episodes=1)
    gif_line(stdout, gif, "eval")

    # -- 39. profiling ----------------------------------------------------------------
    phase("profiling: trace, named_scope, assert_finite, Throughput")
    prof = phase_profiling(dev, kmods)
    print(f"new paths' launches: wrapper {SURFACE_STEPS} steps K1 {surface['counts']['pairforce_sym']}, "
          f"K2 {surface['counts']['reward_sym']}; traced step path 8 steps K1 {prof['counts']['pairforce_sym']}, "
          f"K2 {prof['counts']['reward_sym']}")

    # -- 40. data parallel ----------------------------------------------------------
    phase("data parallel: K5 with an env offset, a gloo world of 2 and an nccl world of 1 on the one card")
    dp_ref = phase_data_parallel(dev, smi.stdout.strip().splitlines()[0])

    # -- 41. tensor parallel ----------------------------------------------------------
    phase("tensor parallel: a gloo world of 2 on the mesh {'data': 1, 'model': 2} on the one card")
    phase_tensor_parallel(dev, smi.stdout.strip().splitlines()[0], dp_ref)

    # -- 42. the bench and the graft entry ----------------------------------------------
    phase("bench SUITE and graft entry")
    bench_res = phase_bench(dev, kmods, smi.stdout.strip().splitlines()[0])
    k1_err = max(k1_err, bench_res["k1_err"])

    # -- 43. the learning hold ---------------------------------------------------------
    phase("learning hold: MAPPO N=3 fused, 80 iterations")
    phase_learning_hold(dev, kmods)

    # bounds from this run's shapes (see bound())
    B, N, E6 = NUM_ENVS, NUM_AGENTS, obs_res["E"]
    stat_bytes = 16 * B * N + 4 * B + 4 * B * N
    soa_bytes = lambda n: 8 * (6 * n + 3)  # SoA state in and out, per env
    actor = lambda n: mlp_flops((6 * n, 64, 64, 2))
    critic = lambda n: mlp_flops((6 * n * n, 64, 64, 1))
    M = k9_res["M"]
    k4b = k4_floors(B, N3_LENGTH, n3)
    bounds = {
        "pairforce_sym": bound(16 * B * N, B * pair_ops(N * (N - 1))),
        "reward_sym": bound(stat_bytes, B * stat_ops(N)),
        "fused_step": bound(44 * B * N + 12 * B, B * (env_step_ops(N) + bfs_policy_ops(N))),
        "fused_rollout": (k4b["bound"], k4b["bound_by"]),
        "fused_collect": bound(B * (soa_bytes(3) + 4 * 25 * (6 * 3 * 3 + 3 * 3 + 3)),
                               B * 25 * (3 * actor(3) + critic(3) + env_step_ops(3))),
        # the forward, the weight gradients (as many multiply-adds as the
        # forward) and the input gradients g2 = gh W3^T, g1 = g2 W2^T
        "fused_ppo_grad": bound(4 * M * (6 * 3 * 3 + 3 * 3 + 3),
                                M * (3 * (2 * actor(3) + mlp_flops((64, 64, 2)))
                                     + 2 * critic(3) + mlp_flops((64, 64, 1)))),
        "pairforce": bound(16 * B * E6 + 16 * E6, B * pair_ops(E6 * (E6 - 1))),
        "reward": bound(stat_bytes, B * stat_ops(N)),
        "pairforce_cull": bound(16 * B * N + 16 * N, pair_ops(sel["k8"]["near"])),
        # a few operations an element against ten floats moved: bytes
        "step_reset": bound(glue.bytes_moved(N, B, glue_resets), 0),
    }
    sel_out = sel["out"]
    src = "gym_formation_tpu_torch/csrc/"
    pallas = "gym_formation_tpu/ops/pallas/"
    rows = (
        ("pairforce_sym", "pairforce_sym.py:264", step_launches["pairforce_sym"], k1_err, k1_ms, k1_plain_ms),
        ("reward_sym", "reward_sym.py:183", step_launches["reward_sym"], k2_err, k2_ms, k2_plain_ms),
        ("fused_step", "fused_step.py:314", fused_launches["fused_step"], k3_err, k3_ms, k3_plain_ms),
        ("fused_rollout", "fused_rollout.py:331", n3_launches["fused_rollout"], k4_err, k4_ms, k4_plain_ms),
        ("fused_collect", "fused_collect.py:345", n3_train["counts"]["fused_collect"], k5_res["err"],
         k5_res["ms"], k5_res["plain_ms"]),
        ("fused_ppo_grad", "fused_ppo_grad.py:248", n3_train["counts"]["fused_ppo_grad"], k9_res["err"],
         k9_res["ms"], k9_res["plain_ms"]),
        ("pairforce", "pairforce.py:108", obs_res["counts"]["pairforce"], k6_err, obs_res["ms"],
         obs_res["plain_ms"]),
        ("reward", "reward.py:136", sel_out["rowmajor"]["counts"]["reward"], k7_err, sel["k7"]["ms"],
         sel["k7"]["plain_ms"]),
        ("pairforce_cull", "pairforce_cull.py:209", sel_out["cull"]["counts"]["pairforce_cull"], k8_err,
         sel["k8"]["ms"], sel["k8"]["plain_ms"]),
        # no TPU kernel: XLA fuses the JAX package's step glue
        ("step_reset", None, fused_launches["step_reset"], glue_err, glue_ms, glue_plain_ms),
    )
    # no single PyTorch call computes any of these functions (torch.cdist
    # gives only the distances of K2 and K7), so library_ms is null
    kernels = [
        dict(name=name, route="cuda", source=src + name + ".cu", replaces=where and pallas + where,
             launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=bounds[name][0], bound_by=bounds[name][1], library_ms=None)
        for name, where, launches, err, ms, plain_ms in rows
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']}: no launch on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
