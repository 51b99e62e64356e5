"""K2 (the reward statistics)'s share of its roofline, %: the least time its launches in the
traced stretch could take (``perfbench.counts.k2_bound_s``) over their device
time in the profiler's trace (kernels named reward_sym_kernel)."""

from perfbench import counts, harness


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("launches")
    if tr is None or not launches or not launches.get("reward_sym"):
        return None
    spent = harness.kernel_seconds(tr, ("reward_sym_kernel",))
    if spent <= 0:
        return None
    return 100.0 * launches["reward_sym"] * counts.k2_bound_s(ctx["n"], ctx["B"]) / spent
