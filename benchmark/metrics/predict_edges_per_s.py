"""Real edges of every prediction completed in the window over the window's
wall time."""

from harness.layers import edges_per_s


def read(ctx):
    return edges_per_s(ctx, "predict")
