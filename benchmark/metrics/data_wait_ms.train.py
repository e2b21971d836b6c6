"""Mean ms a batch of the data module (``next`` on its generator: host
packing and the copies to the card) left the device idle, from the trace."""

from harness.layers import idle_in_span_ms


def read(ctx):
    return idle_in_span_ms(ctx, "train", "pack")
