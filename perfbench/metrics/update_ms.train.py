"""The PPO update, ms an iteration: the mean over the window of stamps on
the card's stream around each update call (K9 and the clipped Adam, or
autograd)."""


def read(ctx):
    v = ctx.get("update_ms") or []
    return sum(v) / len(v) if v else None
