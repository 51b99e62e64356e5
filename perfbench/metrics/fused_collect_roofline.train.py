"""K5 (the fused MAPPO collection)'s share of its roofline, %: the least time its launches in the
traced stretch could take (``perfbench.counts.k5_bound_s``) over their device
time in the profiler's trace (kernels named fused_collect_kernel)."""

from perfbench import counts, harness


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("launches")
    if tr is None or not launches or not launches.get("fused_collect"):
        return None
    spent = harness.kernel_seconds(tr, ("fused_collect_kernel",))
    if spent <= 0:
        return None
    return 100.0 * launches["fused_collect"] * counts.k5_bound_s(ctx["n"], ctx["B"], ctx["T"]) / spent
