"""Percent of the forward TP pipelines' least time reached by the kernels
that run them (B1: ``packed_tp_fwd``)."""

from harness.layers import roofline

PATTERNS = ("packed_tp_fwd",)


def read(ctx):
    return roofline(ctx, "predict", PATTERNS, backward=False)
