"""K9's share of its roofline, %: the least time its launches (the fused
PPO gradient, one an epoch) in the traced stretch could take
(``perfbench.counts.k9_bound_s``) over their device time in the profiler's
trace (kernels named ppo_grad_kernel and slice_sum_kernel)."""

from perfbench import counts, harness


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("launches")
    if tr is None or not launches or not launches.get("fused_ppo_grad"):
        return None
    spent = harness.kernel_seconds(tr, ("ppo_grad_kernel", "slice_sum_kernel"))
    if spent <= 0:
        return None
    return 100.0 * launches["fused_ppo_grad"] * counts.k9_bound_s(ctx["n"], ctx["B"] * ctx["T"]) / spent
