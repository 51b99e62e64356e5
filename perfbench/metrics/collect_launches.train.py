"""Kernel launches of the learner's collection, an iteration: the trace's
``cudaLaunchKernel*`` runtime calls that start inside the program's
``mappo.collect`` annotations, over the annotations' count.  Launches the
runtime API does not see (the driver API's) are not counted."""

from perfbench import spans


def read(ctx):
    if ctx.get("trace") is None:
        return None
    collect = spans.annotations(ctx, "mappo.collect")
    if not collect:
        return None
    starts = [s for cat, n, s, _ in ctx["trace"]["host"] if cat == "cuda_runtime" and n.startswith("cudaLaunchKernel")]
    return sum(any(a <= s < b for a, b in collect) for s in starts) / len(collect)
