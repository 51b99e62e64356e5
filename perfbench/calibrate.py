"""The readings that the limits of the check are set from, on the card at
the cell's own size, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        --control 3 --faults half_batch --fault-seeds 3 --seconds 0.5 --out <file.jsonl>

For each seed, one run of the cell with a window of ``--seconds`` and the
numbers its check compares (the program's readings); on the first
``--control`` seeds also the lower-precision control's numbers; then each
named fault (``perfbench/faults.py``) planted under the timed path, on the
first ``--fault-seeds`` seeds.  One JSON line a run to ``--out`` and to
standard output.  The benchmark's own runs never call it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from perfbench import faults, harness

    drv = harness.cell(args.workload)["workload"]["driver"]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        def emit(rec):
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()

        for i, seed in enumerate(args.seeds):
            t = time.perf_counter()
            res = harness.run(args.workload, seed, args.seconds, False, control=i < args.control)
            emit(dict(kind="program", seed=seed, correct=res["correct"], numbers=res["numbers"],
                      control=res["control"], metrics={k: v["value"] for k, v in res["metrics"].items()},
                      wall_s=time.perf_counter() - t))
        for name in args.faults:
            for seed in args.seeds[: args.fault_seeds]:
                res = harness.run(args.workload, seed, args.seconds, False, fault=faults.by_name(drv, name))
                emit(dict(kind="fault", fault=name, seed=seed, correct=res["correct"], numbers=res["numbers"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
