"""The card's idle time while the host is in the learner's collection, ms
an iteration: the device's idle gaps over the profiled stretch, each
counted by its overlap with the program's ``mappo.collect`` annotations
in the trace, over the annotations' count."""

from perfbench import spans


def read(ctx):
    if ctx.get("trace") is None:
        return None
    collect = spans.annotations(ctx, "mappo.collect")
    if not collect:
        return None
    return 1e-3 * spans.overlap_us(ctx["gaps"], collect) / len(collect)
