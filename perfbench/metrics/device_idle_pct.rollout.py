"""The card's idle share, %: one less the union of the device's activity
intervals over the profiled stretch, from the profiler's trace."""


def read(ctx):
    if ctx.get("trace") is None or not ctx.get("stretch_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["stretch_s"])
