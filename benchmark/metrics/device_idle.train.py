"""Percent of the traced window in which no operation ran on the device."""

from harness.layers import device_idle


def read(ctx):
    return device_idle(ctx, "train")
