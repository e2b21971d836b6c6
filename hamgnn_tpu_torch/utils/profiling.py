"""Device timing, counterpart of ``hamgnn_tpu/utils/profiling.py``
``device_time_ms``."""

from __future__ import annotations

import statistics
import time

import torch


# device clock cycles of busy-waiting put in front of a timed run (~1 ms)
_SPIN_CYCLES = 2_000_000


def device_time_ms(fn, args=(), n: int = 5, warmup: int = 2, device=None) -> float:
    """Median time (ms) of one ``fn(*args)`` over ``n`` runs after ``warmup``.

    ``device`` defaults to that of the first tensor among ``args``; with no
    tensor argument it must be given.  On a CUDA device each run is
    bracketed by CUDA events, so the time is the device's; on the CPU it is
    the host clock around the call.

    Before each timed run the stream is given about a millisecond of
    busy-waiting, so that the host has enqueued the whole of ``fn`` before
    the device reaches the first event: the time between the events is then
    the device's work alone, without the host's launch latency, which for a
    kernel of a few microseconds would be most of the reading.  Work that
    takes the host longer than that to enqueue is host-bound, and its
    reading includes the wait.  The busy-wait is ``torch.cuda._sleep``; a
    PyTorch without it raises, so that a reading never silently holds the
    launch latency."""
    if device is None:
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if first is None:
            raise ValueError("device_time_ms: no tensor among args, so name the device")
        device = first.device
    device = torch.device(device)
    spin = None
    if device.type == "cuda":
        spin = getattr(torch.cuda, "_sleep", None)
        if spin is None:
            raise RuntimeError("device_time_ms needs torch.cuda._sleep to keep the host's "
                               "launch latency out of a reading; this PyTorch has none")
    for _ in range(warmup):
        fn(*args)
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(n):
            spin(_SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
    else:
        for _ in range(n):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_launches(fn, names) -> dict:
    """Launches of device kernels whose names contain each of ``names``
    during one ``fn()``, read from a ``torch.profiler`` trace: what a CUDA
    graph's replay launched, which no host-side counter sees.  Fails where
    the trace holds no device kernel at all (a profiler that cannot see the
    card)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler saw no device kernel: it cannot count launches here")
    return {n: sum(ev.count for ev in kernels if n in ev.key) for n in names}
