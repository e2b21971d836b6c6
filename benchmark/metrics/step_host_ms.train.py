"""Mean ms of a step call during which the device ran nothing (its copy-in
and launch), from the trace."""

from harness.layers import idle_in_span_ms


def read(ctx):
    return idle_in_span_ms(ctx, "train", "step")
