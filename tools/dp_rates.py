"""Training env-steps/s of the port's ``train --mesh DP[,TP]`` runs.

    python tools/dp_rates.py --meshes 1 4 [2,2 1,4] [--dryrun 4] [--device cuda] \\
        [--algo mappo --num-agents 243 --num-envs 1024 --iters 5] [--out chiprun_out/dp_rates.json]

Runs ``python -m gym_formation_tpu_torch.train`` once for each mesh, a
``DP`` or ``DP,TP`` entry (one card a rank with nccl; ``--device cpu``:
gloo; entries are separated by spaces, so ``--meshes 1 4`` runs DP 1 and
DP 4 and ``--meshes 1,4`` one mesh of DP 1 × TP 4), logging every iteration, and reads its ``metrics.jsonl``: the
training env-steps/s is the env steps of the iterations after the first
over their wall (the logger's clock, each row closed by a host fetch of the
metrics).  Beside it the collectives' calls (the model axis's where TP > 1)
and ms an iteration that rank 0 prints (CUDA events on the card), the
parameter and moment bytes a rank holds, and the card's name and power
limit.  ``--dryrun N`` first runs
``python -m gym_formation_tpu_torch.graft_entry N``.  Prints one JSON
object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no card"
    except FileNotFoundError:
        return "no card"


def run(cmd, timeout):
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *cmd], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} failed ({r.returncode}):\n{r.stderr[-4000:]}")
    return r.stdout, time.perf_counter() - t0


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--meshes", nargs="+", default=["1", "4"], help="--mesh values, DP or DP,TP each")
    p.add_argument("--dryrun", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--algo", default="mappo")
    p.add_argument("--num-agents", type=int, default=243)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--timeout", type=int, default=1200)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    result = {"card": card(), "algo": args.algo, "num_agents": args.num_agents, "num_envs": args.num_envs,
              "iters": args.iters, "runs": {}}
    if args.dryrun:
        out, wall = run(["-m", "gym_formation_tpu_torch.graft_entry", str(args.dryrun), "--device", args.device],
                        args.timeout)
        result["dryrun"] = {"ranks": args.dryrun, "process_s": wall,
                            "lines": [line for line in out.splitlines() if line.startswith("dryrun_multichip")]}
        print(out, flush=True)
    for mesh in args.meshes:
        with tempfile.TemporaryDirectory() as d:
            sets = [a for s in args.set for a in ("--set", s)]
            out, wall = run(["-m", "gym_formation_tpu_torch.train", "--algo", args.algo, "--device", args.device,
                             "--num-agents", str(args.num_agents), "--num-envs", str(args.num_envs), "--iters",
                             str(args.iters), "--log-every", "1", "--save-every", "0", "--mesh", mesh,
                             "--run-dir", d, *sets], args.timeout)
            rows = [json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
        steps = rows[-1]["step"] - rows[0]["step"]
        secs = rows[-1]["wall"] - rows[0]["wall"]
        coll = re.search(r"collectives an iteration \(rank 0\): all_reduce ([\d.]+), all_gather ([\d.]+)"
                         r"(?:, model all_gather ([\d.]+), model all_reduce ([\d.]+))?, ([\d.]+) ms", out)
        held = re.search(r"held a rank: params (\d+) B, moments (\d+) B", out)
        num = lambda i: float(coll.group(i)) if coll and coll.group(i) else None
        result["runs"][mesh] = {
            "env_steps_per_s": steps / secs if secs > 0 else None,
            "iteration_walls_s": [b["wall"] - a["wall"] for a, b in zip(rows, rows[1:])],
            "all_reduce_calls": num(1),
            "all_gather_calls": num(2),
            "model_all_gather_calls": num(3),
            "model_all_reduce_calls": num(4),
            "collective_ms": num(5),
            "held_bytes": {"params": int(held.group(1)), "moments": int(held.group(2))} if held else None,
            "mean_step_reward": [r["mean_step_reward"] for r in rows],
            "process_s": wall,
        }
        print(f"--mesh {mesh}: {result['runs'][mesh]}", flush=True)
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
