"""The clipped Adam (``ClipAdam`` over every parameter), ms an iteration:
the program's ``mappo.apply`` spans on the card's stream over the
iterations of the traced stretch (its ``mappo.collect`` spans)."""

from perfbench import spans


def read(ctx):
    return spans.per(ctx, "mappo.apply", "mappo.collect")
