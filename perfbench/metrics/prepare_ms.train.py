"""The learner's preparation (GAE, the value-norm update, flattening), ms
an iteration: the program's ``mappo.prepare`` spans on the card's stream
over the iterations of the traced stretch (its ``mappo.collect`` spans)."""

from perfbench import spans


def read(ctx):
    return spans.per(ctx, "mappo.prepare", "mappo.collect")
