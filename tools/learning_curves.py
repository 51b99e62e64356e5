"""Hold the port's training curves to the reference's learning curves.

    python tools/learning_curves.py runs/torch_<row>_s*          # check logs against their rows
    python tools/learning_curves.py list                          # every row and its command
    python tools/learning_curves.py run <row> [<row> ...] [--seeds 1 2 3] [--jobs 2] \\
        [--run-root build/curves] [--export chiprun_out/curves]

``TARGETS`` holds one row per protocol of the reference (RESULTS.md and the
logs under ``runs/``): the exact ``python -m gym_formation_tpu_torch.train``
command (and, for the recurrent zoo, the ``eval`` command), the kernels on
its path, the reference's values at given steps with their sources, and
what each held quantity is compared with.  A run's directory is named
``torch_<row>_s<seed>`` and holds the train's ``metrics.jsonl`` and
``run.json`` (the command, the kernel launch counts the train process
printed, the eval's returns, the card's name and power limit).

The rule, fixed before any run of the port:

- the value of a metric at a step is the mean of the logged points within
  ±5% of that step, pooled over seeds; each seed's own mean beside it;
- the port's value at each target step lies within
  ``0.25 × |reference improvement from its start to the last target step|``
  of the reference's value, two-sided, plus ``2 ×`` the seeds' standard
  deviation (ddof 1) where several seeds ran;
- where the reference records the entropy, the port's mean entropy over
  the reference run's second half (its steps from half its last step on)
  lies within ±0.3 nats of the reference's over the same steps; where it
  records only the final entropy, the port's at the last target step;
- the recurrent zoo's greedy eval return (10 episodes of 25 steps) is held
  one-sided: no worse than the reference's mean − 2 × its std.

``run`` trains each (row, seed) in a process of its own, ``--jobs`` at a
time, into ``--run-root``, then copies ``metrics.jsonl`` and ``run.json``
to ``--export`` (the checkpoints stay behind).  The check prints one line
per held quantity and exits 1 when any row that ran is out of band.  Imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import glob
import json
import math
import os
import re
import shlex
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from dp_rates import card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = 0.05  # ± this share of a target step
BAND_SHARE = 0.25  # of the reference's improvement
SEED_SDS = 2.0
ENTROPY_NATS = 0.3
EVAL_SDS = 2.0


@dataclasses.dataclass(frozen=True)
class Point:
    """A reference value at ``step``: ``value`` from RESULTS.md, or None to
    read it from the row's reference log by the window rule."""

    step: int
    value: Optional[float]
    source: str


@dataclasses.dataclass(frozen=True)
class Entropy:
    """The reference's entropy: ``how`` is "second_half" (the log's mean
    over its second half; ``value`` None) or "end" (RESULTS.md's final
    value, held at the last target step)."""

    how: str
    value: Optional[float]
    source: str


@dataclasses.dataclass(frozen=True)
class Eval:
    """The reference's greedy eval return (mean ± std over its episodes)."""

    args: Tuple[str, ...]  # of python -m gym_formation_tpu_torch.eval, without --ckpt and --algo
    mean: float
    std: float
    source: str


@dataclasses.dataclass(frozen=True)
class Target:
    name: str
    train: Tuple[str, ...]  # of python -m gym_formation_tpu_torch.train, without --seed and --run-dir
    kernels: str
    seeds: Tuple[int, ...]
    start: Point  # the reference's first value: the base of its improvement
    points: Tuple[Point, ...]
    log: Optional[str] = None  # the reference's metrics.jsonl, for values read from it
    entropy: Optional[Entropy] = None
    eval: Optional[Eval] = None
    launches: Optional[Dict[str, int]] = None  # the train process's exact kernel launches
    assumptions: str = ""


KERNELS = ("pairforce_sym", "reward_sym", "fused_step", "fused_rollout", "fused_collect", "fused_ppo_grad",
           "pairforce", "reward", "pairforce_cull")


def only(**counts) -> Dict[str, int]:
    """Launch counts: the given kernels, every other 0."""
    return {k: counts.get(k, 0) for k in KERNELS}


N3 = ("--algo", "mappo", "--num-agents", "3", "--num-envs", "1024", "--iters", "391", "--log-every", "2",
      "--save-every", "0")
N3_NOTE = ("The reference ran train.py at 1024 envs (RESULTS.md:677-684) with the default config "
           "(rollout 25, 10 epochs, entropy_coef 0.01, episode_length 100, none named there); its TPU gate "
           "turned fused collection on (num_envs % 512 == 0), its update was autograd. 391 iterations = "
           "10,009,600 steps.")
ZOO = ("--num-envs", "32", "--iters", "2000", "--log-every", "10", "--save-every", "0")
ZOO_NOTE = ("The reference's zoo protocol: 32 envs x 2000 train_steps of 32 env steps (RESULTS.md:617-620), "
            "the default config and episode_length 100; its logs start at step 1024 (one iteration). Held from "
            "410k steps on: both packages fall far in the first iterations.")
ZOO_STEPS = (410_624, 820_224, 1_229_824, 1_639_424)
REC = ("--num-envs", "32", "--episode-length", "25", "--iters", "320", "--log-every", "2", "--save-every", "320")
REC_EVAL = ("--policy", "ckpt", "--episode-length", "25", "--episodes", "10")
REC_NOTE = ("The reference's recurrent protocol (RESULTS.md:322-326): 32 envs, episodes of 25, 320 iterations "
            "of 8 episodes = 2,048,000 steps; greedy eval over 10 x 25-step episodes. Its start value is its "
            "first logged iteration; the final one is held at 2,048,000.")


def _zoo(algo: str, name: str, ref: str, extra: Tuple[str, ...] = (), entropy: Optional[Entropy] = None):
    return Target(
        name=name, train=("--algo", algo) + extra + ZOO, kernels="K1, K2 every env step", seeds=(1,),
        start=Point(1024, None, f"runs/{ref}/metrics.jsonl step 1024"),
        points=tuple(Point(s, None, f"runs/{ref}/metrics.jsonl step {s:,}") for s in ZOO_STEPS),
        log=f"runs/{ref}/metrics.jsonl", entropy=entropy, assumptions=ZOO_NOTE)


def _rec(algo: str, start: float, end: float, line: int, ev: Tuple[float, float]):
    src = f"RESULTS.md:{line}"
    return Target(
        name=f"{algo}_n3", train=("--algo", algo) + REC, kernels="K1, K2 every env step", seeds=(1,),
        start=Point(6400, start, src), points=(Point(2_048_000, end, src),),
        eval=Eval(REC_EVAL, ev[0], ev[1], src), assumptions=REC_NOTE)


TARGETS: Dict[str, Target] = {t.name: t for t in (
    # 1. MAPPO N=3 continuous, both update routes
    Target(
        name="mappo_n3_fused", train=N3 + ("--set", "fused_update=True"),
        kernels="K5 once an iteration (the auto gate), K9 ten times an iteration", seeds=(1, 2, 3),
        start=Point(25_600, -5.25, "RESULTS.md:683"), points=(Point(10_009_600, -2.27, "RESULTS.md:683"),),
        launches=only(fused_collect=391, fused_ppo_grad=3910),
        assumptions=N3_NOTE + " This route adds the fused update (K9), which the reference did not run."),
    Target(
        name="mappo_n3_autograd", train=N3, kernels="K5 once an iteration (the auto gate)", seeds=(1, 2, 3),
        start=Point(25_600, -5.25, "RESULTS.md:683"), points=(Point(10_009_600, -2.27, "RESULTS.md:683"),),
        launches=only(fused_collect=391), assumptions=N3_NOTE),
    # 2. discrete MAPPO N=3
    Target(
        name="mappo_n3_discrete",
        train=("--algo", "mappo", "--discrete-action", "--num-envs", "512", "--iters", "600", "--log-every", "3",
               "--save-every", "0"),
        kernels="the categorical head; K1, K2 every env step", seeds=(1, 2, 3),
        start=Point(12_800, -4.89, "RESULTS.md:638"), points=(Point(7_680_000, -2.62, "RESULTS.md:638"),),
        entropy=Entropy("end", 0.59, "RESULTS.md:638-639"),
        assumptions=("600 iterations x 512 envs x 25-step rollouts (RESULTS.md:637), the default config and "
                     "episode_length 100. RESULTS.md records the entropy's end only (1.609 -> 0.59), so the "
                     "port's entropy is held at the last target step.")),
    # 3. MAPPO N=243 structured, signed auto-entropy
    Target(
        name="mappo_n243_signedalpha",
        train=("--algo", "mappo", "--num-agents", "243", "--num-envs", "1024", "--episode-length", "25",
               "--benchmark", "--iters", "2500", "--log-every", "20", "--save-every", "0",
               "--set", "auto_entropy=True"),
        kernels="the structured first layers; K1, K2 every env step", seeds=(1,),
        start=Point(25_600, None, "runs/mappo_n243_signedalpha/metrics.jsonl step 25,600"),
        points=tuple(Point(s, None, f"runs/mappo_n243_signedalpha/metrics.jsonl step {s:,}")
                     for s in (2_560_000, 12_800_000, 25_600_000, 38_400_000, 51_200_000, 63_500_000)),
        log="runs/mappo_n243_signedalpha/metrics.jsonl",
        entropy=Entropy("second_half", None, "runs/mappo_n243_signedalpha/metrics.jsonl"),
        assumptions=("The command is not recorded (the log came without it). RESULTS.md:217-219 gives the "
                     "campaign's B=1024, episode_length 25 and the benchmark quartet every 20 iterations (the "
                     "log's bench_* keys); RESULTS.md:266 gives 2,500 iterations; the log's alpha gives "
                     "auto_entropy=True at the default alpha_max 0.05 and entropy_target "
                     "act_dim*(1.419 + ln 0.5) = 1.45.")),
    # 4. the feed-forward off-policy zoo
    Target(
        name="maddpg_n3", train=("--algo", "maddpg") + ZOO, kernels="K1, K2 every env step", seeds=(1,),
        start=Point(1024, -4.43, "RESULTS.md:601"), points=(Point(2_048_000, -2.00, "RESULTS.md:601"),),
        assumptions=ZOO_NOTE + " MADDPG has no committed log: RESULTS.md gives its start and its 2M value."),
    _zoo("matd3", "matd3_n3", "matd3_n3_conv"),
    _zoo("masac", "masac_n3", "masac_n3_conv",
         entropy=Entropy("second_half", None, "runs/masac_n3_conv/metrics.jsonl")),
    _zoo("qmix", "qmix_n3", "qmix_n3_conv"),
    # 5. the recurrent off-policy zoo, then eval
    _rec("rmaddpg", -4.24, -3.08, 332, (-71.9, 19.9)),
    _rec("rmatd3", -4.24, -3.23, 333, (-70.8, 4.9)),
    _rec("rmasac", -4.67, -3.38, 334, (-89.9, 21.8)),
    _rec("rqmix", -4.72, -2.63, 335, (-68.1, 18.8)),
    _rec("rvdn", -4.72, -2.79, 336, (-66.5, 16.9)),
    # 6. RMAPPO, the reference's tuned configuration
    Target(
        name="rmappo_n3",
        train=("--algo", "rmappo", "--num-envs", "128", "--episode-length", "25", "--iters", "6250",
               "--log-every", "25", "--save-every", "0"),
        kernels="the autograd paths; K1, K2 every env step", seeds=(1,),
        start=Point(3200, -5.42, "RESULTS.md:312"), points=(Point(20_000_000, -1.18, "RESULTS.md:312"),),
        assumptions=("The reference's tuned run (RESULTS.md:300-312): 128 envs, episodes of 25, 6,250 "
                     "iterations = 20M steps, the default config. RESULTS.md:311 gives -1.58 for its round-3 "
                     "re-run; -1.18 is the value held.")),
)}


# -- reading and the window rule ------------------------------------------------

def read_log(path: str) -> List[dict]:
    """The rows of a metrics.jsonl (a line cut short by a killed run skipped)."""
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def window(rows: Sequence[dict], step: int, key: str) -> List[float]:
    """The logged values of ``key`` within ±5% of ``step``."""
    return [float(r[key]) for r in rows if key in r and abs(r["step"] - step) <= WINDOW * step]


def mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs)


def sd(xs: Sequence[float]) -> float:
    """The standard deviation over seeds (ddof 1); 0 for one seed."""
    if len(xs) < 2:
        return 0.0
    m = mean(xs)
    return math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1))


def value_at(logs: Sequence[Sequence[dict]], step: int, key: str = "mean_step_reward"):
    """(pooled mean, each seed's mean, sd over seeds) at ``step``, or None
    where a log has no point in the window."""
    per = [window(rows, step, key) for rows in logs]
    if not all(per):
        return None
    seeds = [mean(w) for w in per]
    return mean([x for w in per for x in w]), seeds, sd(seeds)


def second_half(rows: Sequence[dict], key: str, last_step: int) -> List[float]:
    """Values of ``key`` at steps from ``last_step / 2`` to ``last_step``."""
    return [float(r[key]) for r in rows if key in r and last_step / 2 <= r["step"] <= last_step]


def band(ref_start: float, ref_last: float, seed_sd: float = 0.0) -> float:
    return BAND_SHARE * abs(ref_last - ref_start) + SEED_SDS * seed_sd


def eval_floor(ref_mean: float, ref_std: float) -> float:
    return ref_mean - EVAL_SDS * ref_std


# -- the check -------------------------------------------------------------------

@dataclasses.dataclass
class Line:
    ok: bool
    text: str


def reference_value(t: Target, p: Point, ref_log: Optional[List[dict]], key: str = "mean_step_reward") -> float:
    if p.value is not None:
        return p.value
    got = value_at([ref_log], p.step, key)
    if got is None:
        raise ValueError(f"{t.name}: the reference log {t.log} has no point within 5% of step {p.step}")
    return got[0]


def check_target(t: Target, dirs: Sequence[str], repo: str = REPO) -> List[Line]:
    """One Line per held quantity of row ``t`` over the runs in ``dirs``."""
    logs = [read_log(os.path.join(d, "metrics.jsonl")) for d in dirs]
    runs = [read_run(d) for d in dirs]
    ref_log = read_log(os.path.join(repo, t.log)) if t.log else None
    start = reference_value(t, t.start, ref_log)
    last = reference_value(t, t.points[-1], ref_log)
    lines = []
    for p in t.points:
        ref = reference_value(t, p, ref_log)
        got = value_at(logs, p.step)
        what = f"mean_step_reward @ {p.step:,}"
        if got is None:
            lines.append(Line(False, f"{what}: a log has no point within 5% (ref {ref:.4f}, {p.source})"))
            continue
        port, seeds, s = got
        b = band(start, last, s)
        diff = abs(port - ref)
        seeds_txt = f" (seeds {' '.join(f'{x:.4f}' for x in seeds)}, sd {s:.4f})" if len(seeds) > 1 else ""
        lines.append(Line(diff <= b, f"{what}: port {port:.4f}{seeds_txt}, ref {ref:.4f} ({p.source}); "
                                     f"|diff| {diff:.4f} vs band {b:.4f}: "
                                     f"{'in band' if diff <= b else 'OUT OF BAND'} by {abs(b - diff):.4f}"))
    if t.entropy is not None:
        if t.entropy.how == "second_half":
            end = ref_log[-1]["step"]
            ref = mean(second_half(ref_log, "entropy", end))
            vals = [x for rows in logs for x in second_half(rows, "entropy", end)]
            what = f"entropy over steps {end / 2:,.0f}-{end:,}"
            port = mean(vals) if vals else float("nan")
        else:
            ref = t.entropy.value
            got = value_at(logs, t.points[-1].step, "entropy")
            what = f"entropy @ {t.points[-1].step:,}"
            port = got[0] if got else float("nan")
        diff = abs(port - ref)
        ok = diff <= ENTROPY_NATS
        lines.append(Line(ok, f"{what}: port {port:.4f}, ref {ref:.4f} ({t.entropy.source}); |diff| "
                              f"{diff:.4f} vs {ENTROPY_NATS} nats: {'in band' if ok else 'OUT OF BAND'}"))
    if t.eval is not None:
        floor = eval_floor(t.eval.mean, t.eval.std)
        evs = [r.get("eval") for r in runs]
        what = "greedy eval return"
        if not all(evs):
            lines.append(Line(False, f"{what}: no eval in run.json (ref {t.eval.mean} ± {t.eval.std})"))
        else:
            port = mean([e["mean"] for e in evs])
            ok = port >= floor
            lines.append(Line(ok, f"{what}: port {port:.2f} ± {mean([e['std'] for e in evs]):.2f}, ref "
                                  f"{t.eval.mean} ± {t.eval.std} ({t.eval.source}); floor {floor:.2f}: "
                                  f"{'in band' if ok else 'OUT OF BAND'} by {abs(port - floor):.2f}"))
    if t.launches is not None:
        for d, r in zip(dirs, runs):
            got = r.get("launches")
            ok = got == t.launches
            lines.append(Line(ok, f"kernel launches {os.path.basename(d)}: "
                                  f"{'as expected' if ok else 'DIFFER'} {got}"))
    return lines


def read_run(d: str) -> dict:
    path = os.path.join(d, "run.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def rate(rows: Sequence[dict]) -> Optional[float]:
    """Training env-steps/s between the first and the last logged row."""
    if len(rows) < 2 or rows[-1]["wall"] <= rows[0]["wall"]:
        return None
    return (rows[-1]["step"] - rows[0]["step"]) / (rows[-1]["wall"] - rows[0]["wall"])


def row_of(d: str) -> Tuple[str, int]:
    m = re.fullmatch(r"torch_(.+)_s(\d+)", os.path.basename(os.path.normpath(d)))
    if not m or m.group(1) not in TARGETS:
        raise SystemExit(f"{d}: not a run directory torch_<row>_s<seed> of a TARGETS row")
    return m.group(1), int(m.group(2))


def check(dirs: Sequence[str], repo: str = REPO) -> bool:
    """Print the verdict of every row among ``dirs``; True when all are in band."""
    groups: Dict[str, List[str]] = {}
    for d in sorted(dirs):
        groups.setdefault(row_of(d)[0], []).append(d)
    all_ok = True
    for name, ds in groups.items():
        t = TARGETS[name]
        lines = check_target(t, ds, repo)
        ok = all(x.ok for x in lines)
        all_ok &= ok
        seeds = [row_of(d)[1] for d in ds]
        logs = [read_log(os.path.join(d, "metrics.jsonl")) for d in ds]
        walls = ", ".join(f"{rows[-1]['wall']:.1f}" for rows in logs)
        rates = ", ".join(f"{r:.1f}" if r else "-" for r in map(rate, logs))
        card = {read_run(d).get("card", "card not recorded") for d in ds}
        print(f"{name}: {'IN BAND' if ok else 'OUT OF BAND'}; seeds {seeds}; {t.kernels}; wall {walls} s; "
              f"training env-steps/s {rates}; {'; '.join(sorted(card))}")
        for x in lines:
            print(f"  {'ok ' if x.ok else 'BAD'} {x.text}")
    return all_ok


# -- the runs --------------------------------------------------------------------

def run_one(t: Target, seed: int, run_root: str, export: Optional[str], threads: int, extra: Sequence[str],
            also: Sequence[str] = ()) -> dict:
    """Train (and eval) one seed of row ``t``; returns its run.json."""
    run_dir = os.path.join(run_root, f"torch_{t.name}_s{seed}")
    if os.path.exists(os.path.join(run_dir, "metrics.jsonl")):
        raise SystemExit(f"{run_dir} already holds a metrics.jsonl: a run appends to it; pick a fresh --run-root")
    os.makedirs(run_dir, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": str(threads)}
    cmd = [sys.executable, "-m", "gym_formation_tpu_torch.train", *t.train, "--seed", str(seed),
           "--run-dir", run_dir, *extra, *also]
    t0 = time.time()
    with open(os.path.join(run_dir, "train.log"), "w") as log:
        rc = subprocess.run(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT).returncode
    rec = dict(row=t.name, seed=seed, command=" ".join(["python", *cmd[1:]]), returncode=rc,
               seconds=round(time.time() - t0, 3), card=card(), launches=launches_of(run_dir))
    if t.eval is not None and rc == 0:
        algo = t.train[t.train.index("--algo") + 1]
        ecmd = [sys.executable, "-m", "gym_formation_tpu_torch.eval", *t.eval.args, "--algo", algo,
                "--ckpt", os.path.join(run_dir, "ckpt"), *extra]
        out = subprocess.run(ecmd, cwd=REPO, env=env, capture_output=True, text=True)
        rec["eval_command"] = " ".join(["python", *ecmd[1:]])
        rec["eval"] = parse_eval(out.stdout) if out.returncode == 0 else None
        with open(os.path.join(run_dir, "eval.log"), "w") as f:
            f.write(out.stdout + out.stderr)
    with open(os.path.join(run_dir, "run.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if export:
        dst = os.path.join(export, os.path.basename(run_dir))
        os.makedirs(dst, exist_ok=True)
        for name in ("metrics.jsonl", "run.json", "train.log", "eval.log"):
            if os.path.exists(os.path.join(run_dir, name)):
                shutil.copy(os.path.join(run_dir, name), dst)
    print(f"{t.name} seed {seed}: rc {rc}, {rec['seconds']} s", flush=True)
    return rec


def launches_of(run_dir: str) -> Optional[Dict[str, int]]:
    """The kernel launch counts the train process printed last."""
    found = None
    with open(os.path.join(run_dir, "train.log")) as f:
        for line in f:
            if line.startswith("kernel launches: "):
                found = json.loads(line[len("kernel launches: "):])
    return found


def parse_eval(stdout: str) -> Optional[dict]:
    rets = [float(m) for m in re.findall(r"^episode \d+: return=(-?[\d.]+)", stdout, re.M)]
    m = re.search(r"mean return over \d+ episodes: (-?[\d.]+) ± ([\d.]+)", stdout)
    return dict(mean=float(m.group(1)), std=float(m.group(2)), returns=rets) if m else None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["list"]:
        for t in TARGETS.values():
            ev = f"; then python -m gym_formation_tpu_torch.eval {' '.join(t.eval.args)} --ckpt <run-dir>/ckpt" \
                if t.eval else ""
            print(f"{t.name} (seeds {list(t.seeds)}; {t.kernels}): python -m gym_formation_tpu_torch.train "
                  f"{' '.join(t.train)} --seed <seed> --run-dir runs/torch_{t.name}_s<seed>{ev}\n  {t.assumptions}")
        return 0
    if argv[:1] == ["run"]:
        p = argparse.ArgumentParser(prog="learning_curves.py run")
        p.add_argument("rows", nargs="+", choices=sorted(TARGETS))
        p.add_argument("--seeds", type=int, nargs="*", default=None, help="default: each row's own")
        p.add_argument("--jobs", type=int, default=1, help="runs at once (they share the card and the cores)")
        p.add_argument("--run-root", default="runs")
        p.add_argument("--export", default=None, help="copy each run's logs here")
        p.add_argument("--device", default=None, help="passed to train and eval (default: theirs, cuda)")
        p.add_argument("--also", default="", help="train arguments appended to the row's (a rehearsal's "
                       "smaller size on the CPU: they override the row's, and the run holds no target)")
        a = p.parse_args(argv[1:])
        extra = ("--device", a.device) if a.device else ()
        jobs = [(TARGETS[r], s) for r in a.rows for s in (a.seeds or TARGETS[r].seeds)]
        threads = max(1, (os.cpu_count() or 1) // a.jobs)
        with concurrent.futures.ThreadPoolExecutor(a.jobs) as ex:
            futs = [ex.submit(run_one, t, s, a.run_root, a.export, threads, extra, shlex.split(a.also))
                    for t, s in jobs]
            recs = [f.result() for f in futs]
        dirs = [os.path.join(a.run_root, f"torch_{r['row']}_s{r['seed']}") for r in recs]
        bad = [r for r in recs if r["returncode"] != 0]
        ok = check([d for d, r in zip(dirs, recs) if r["returncode"] == 0])
        return 1 if bad or not ok else 0
    p = argparse.ArgumentParser(description="check runs against their TARGETS rows")
    p.add_argument("dirs", nargs="+", help="run directories torch_<row>_s<seed> (globs expanded)")
    a = p.parse_args(argv)
    dirs = [d for pat in a.dirs for d in (sorted(glob.glob(pat)) or [pat])]
    return 0 if check(dirs) else 1


if __name__ == "__main__":
    sys.exit(main())
