"""The host's time in the rollout's auto-reset, ms a step: the summed
durations of the program's ``env.reset`` marks in the trace over the
count of its ``rollout.k3`` marks (the steps).  Host time under the
profiler, which adds its own cost to each operator."""

from perfbench import spans


def read(ctx):
    if ctx.get("trace") is None:
        return None
    steps = spans.annotations(ctx, "rollout.k3")
    if not steps:
        return None
    return 1e-3 * sum(e - s for s, e in spans.annotations(ctx, "env.reset")) / len(steps)
