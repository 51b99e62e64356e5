"""Device time a step outside K3 and the masked K2 (the auto-reset's draw,
the selects, the glue), ms, from the profiler's trace: all device
operations' time in the traced stretch less the two kernels', over the
steps it holds (K3's launches)."""

from perfbench import harness


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("launches")
    if tr is None or not launches or not launches.get("fused_step"):
        return None
    total = sum(e - s for s, e in tr["device"]) * 1e-6
    kernels = harness.kernel_seconds(tr, ("fused_step_kernel", "reward_sym_kernel"))
    return 1e3 * (total - kernels) / launches["fused_step"]
