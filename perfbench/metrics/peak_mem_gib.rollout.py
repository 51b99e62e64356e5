"""The allocator's peak on the fullest card over the run, GiB
(``torch.cuda.max_memory_allocated``)."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx.get("peak_bytes") else None
