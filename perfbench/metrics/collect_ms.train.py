"""The learner's collection, ms an iteration: the mean over the window of
stamps on the card's stream around each collection call (K5; or the
step-by-step collection through the env's step on K1 and K2)."""


def read(ctx):
    v = ctx.get("collect_ms") or []
    return sum(v) / len(v) if v else None
