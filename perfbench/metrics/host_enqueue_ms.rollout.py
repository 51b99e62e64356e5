"""The rollout loop's host time, ms an env step: the host clock around each
chunk's call, which returns once the chunk is enqueued, over the chunk's
steps."""


def read(ctx):
    return ctx.get("host_enqueue_ms")
