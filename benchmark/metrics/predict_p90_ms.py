"""90th percentile of every prediction's latency in the window: from asking
the data module for the batch to the Hamiltonian on the host."""

from harness.layers import latency_ms


def read(ctx):
    return latency_ms(ctx, "predict", 90)
