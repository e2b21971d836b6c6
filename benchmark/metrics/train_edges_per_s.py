"""Real edges of every training step completed in the window over the
window's wall time."""

from harness.layers import edges_per_s


def read(ctx):
    return edges_per_s(ctx, "train")
