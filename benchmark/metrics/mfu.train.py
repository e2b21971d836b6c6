"""Percent of the H100's dense fp32 peak reached by the model's FLOPs over
the window."""

from harness.layers import mfu


def read(ctx):
    return mfu(ctx, "train")
