"""Percent of the backward TP pipelines' least time reached by the kernels
that run them (B2: ``packed_tp_bwd``)."""

from harness.layers import roofline

PATTERNS = ("packed_tp_bwd",)


def read(ctx):
    return roofline(ctx, "train", PATTERNS, backward=True)
