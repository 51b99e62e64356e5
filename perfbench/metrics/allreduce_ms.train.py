"""The data-parallel exchange, ms an iteration: rank 0's collective time
from the mesh's own counters with timing on (CUDA events around each
``all_reduce`` of the flat gradient and of the advantage statistics)."""


def read(ctx):
    return ctx.get("allreduce_ms")
