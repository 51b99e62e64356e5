"""The whole step's share of the card's FP32 peak, %: the configuration's
operations in the window (``perfbench.counts``, one count whichever path
runs the work) over the window's seconds at 67 TFLOP/s."""


def read(ctx):
    return ctx.get("mfu")
