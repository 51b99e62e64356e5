"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python -m perfbench.run  (the same)

From the root of a checkout with a card.  Prints the result as one JSON
line, the last of standard output, and each number compared with its limit
as the last lines of standard error.  Without a card, or with fewer cards
than the cell asks for, it exits with an error and prints no result.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        from perfbench import harness
        import gym_formation_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        print(f"perfbench: cannot import the program: {e}", file=sys.stderr)
        return 2
    try:
        res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    except harness.NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in res["checks"].items():
        v, lim = c["value"], c["limit"]
        ok = isinstance(v, float) and math.isfinite(v) and v <= lim
        print(f"check {k} {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}", file=sys.stderr)
    print(harness.result_line(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
