"""The arithmetic the metric files share.  Each returns None where the run
has nothing for it to read (another kind of traffic, an untraced run, no
matching kernel on the device)."""

from __future__ import annotations

import numpy as np

from .work import PEAK_FP32_FLOPS

# forwards a training step counts: the forward and a backward at twice it
TRAIN_FORWARDS = 3


def edges_per_s(ctx, kind: str):
    if ctx.kind != kind or not ctx.run.items:
        return None
    return sum(e for _n, e in ctx.run.items) / ctx.run.window_s


def latency_ms(ctx, kind: str, q: float):
    if ctx.kind != kind or not ctx.run.latency_s:
        return None
    return float(np.percentile(np.asarray(ctx.run.latency_s), q)) * 1e3


def idle_in_span_ms(ctx, kind: str, span: str):
    """Mean ms, over the window's ``span`` spans, during which the device
    ran nothing while the host was in the span: what the device waited for
    it, from the trace."""
    trace = ctx.run.trace
    if ctx.kind != kind or trace is None:
        return None
    found = [(a, b) for name, a, b in trace.spans if name == span]
    if not found:
        return None
    return sum((b - a) - trace.busy_within(a, b) for a, b in found) / len(found) * 1e3


def mfu(ctx, kind: str):
    """Percent of the fp32 peak: the model's FLOPs of every step or
    prediction in the window over the window's wall time."""
    if ctx.kind != kind or ctx.work is None or not ctx.run.items:
        return None
    forwards = TRAIN_FORWARDS if kind == "train" else 1
    flops = sum(ctx.work.forward_flops(n, e) for n, e in ctx.run.items) * forwards
    return 100.0 * flops / ctx.run.window_s / PEAK_FP32_FLOPS


def roofline(ctx, kind: str, patterns, backward: bool):
    """Percent: the TP pipelines' least time over the device time of the
    kernels whose names hold ``patterns``."""
    trace = ctx.run.trace
    if ctx.kind != kind or trace is None or ctx.work is None:
        return None
    kernel_s = trace.op_seconds(patterns)
    if kernel_s <= 0:
        return None
    least = sum(ctx.work.tp_least_s(e, backward) for _n, e in ctx.run.items)
    return 100.0 * least / kernel_s


def device_idle(ctx, kind: str):
    trace = ctx.run.trace
    if ctx.kind != kind or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
