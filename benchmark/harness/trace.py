"""What the traced run reads from ``torch.profiler``: the device's operations
(kernels, copies, fills) and the benchmark's own host spans
(``record_function("bench/<name>")``) on one clock, the device's busy time
in the window, its idle gaps named by the host span they fall in, and the
device operations that took most time.

The kinds of kernel are a frozen copy of
``hamgnn_tpu_torch/tools_dev/profile_summary.py`` ``KINDS``.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Dict, List, Tuple

# (kind, substrings of a kernel name), the first match wins
KINDS = (
    ("tp_kernels", ("packed_tp_", "zonal_tp_")),
    ("products", ("gemm", "cutlass::Kernel2", "splitKreduce")),
    ("fills", ("FillFunctor",)),
    ("adds", ("CUDAFunctor_add",)),
    ("muls", ("MulFunctor",)),
    ("copies", ("copy", "Memcpy", "CatArray")),
    ("index_scatter", ("index", "scatter", "gather")),
    ("reductions", ("reduce_kernel",)),
)

SPAN_PREFIX = "bench/"
WINDOW = "window"


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


@dataclasses.dataclass(eq=False)
class Trace:
    """Device operations and host spans, in seconds from the window's start,
    clipped to the window."""
    window_s: float
    ops: List[Tuple[str, float, float]]     # (name, start, end)
    spans: List[Tuple[str, float, float]]   # (span name, start, end)

    @functools.cached_property
    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out: List[List[float]] = []
        for _n, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @functools.cached_property
    def _busy_prefix(self) -> List[float]:
        out = [0.0]
        for a, b in self.busy_intervals:
            out.append(out[-1] + b - a)
        return out

    @functools.cached_property
    def _spans_sorted(self):
        spans = sorted(self.spans, key=lambda s: s[1])
        return spans, [s[1] for s in spans]

    def busy_s(self) -> float:
        return self._busy_prefix[-1]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], 0.0
        for a, b in self.busy_intervals:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        return gaps

    def span_at(self, t: float) -> str:
        """The host span open at ``t`` (the benchmark's spans do not nest),
        or ``other``."""
        spans, starts = self._spans_sorted
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][2] >= t:
            return spans[i][0]
        return "other"

    def busy_before(self, t: float) -> float:
        """Busy seconds of the device in [0, t]."""
        busy = self.busy_intervals
        i = bisect.bisect_right(self._starts, t)
        done = self._busy_prefix[i]
        if i and busy[i - 1][1] > t:
            done -= busy[i - 1][1] - t
        return done

    @functools.cached_property
    def _starts(self) -> List[float]:
        return [a for a, _b in self.busy_intervals]

    def busy_within(self, a: float, b: float) -> float:
        return self.busy_before(b) - self.busy_before(a)

    def op_seconds(self, patterns) -> float:
        """Seconds of the device operations whose names hold any of
        ``patterns``."""
        return sum(e - s for n, s, e in self.ops if any(p in n for p in patterns))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, List[float]] = {}
        for a, b in self.idle_gaps():
            gaps.setdefault(self.span_at(0.5 * (a + b)), []).append(b - a)
        idle = sorted(((f"{name}: {len(v)} gaps, longest {max(v) * 1e3:.3f} ms", sum(v))
                       for name, v in gaps.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[f"[{kind_of(n)}] {n[:160]}", s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


def _times(ev) -> Tuple[float, float]:
    if hasattr(ev, "start_ns"):
        a = ev.start_ns() * 1e-9
        return a, a + ev.duration_ns() * 1e-9
    a = ev.start_us() * 1e-6
    return a, a + ev.duration_us() * 1e-6


def _annotation(ev) -> bool:
    """A user range on the device's timeline (the program's own
    ``record_function``), not an operation."""
    check = getattr(ev, "is_user_annotation", None)
    return bool(check()) if check is not None else False


def read(prof) -> Trace:
    """The window's device operations and host spans from a finished
    ``torch.profiler.profile`` that recorded CPU and CUDA activity and one
    ``bench/window`` span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(SPAN_PREFIX):
            # a host span is traced twice: on the host, and as its range on
            # the device's timeline, which is no device operation
            if ev.device_type() != cuda:
                spans.append((name[len(SPAN_PREFIX):],) + _times(ev))
        elif ev.device_type() == cuda and not _annotation(ev):
            ops.append((name,) + _times(ev))
    win = [s for s in spans if s[0] == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window spans, not one")
    _, t0, t1 = win[0]

    def clip(items):
        return [(n, max(a, t0) - t0, min(b, t1) - t0) for n, a, b in items if b > t0 and a < t1]

    return Trace(window_s=t1 - t0, ops=clip(ops),
                 spans=[s for s in clip(spans) if s[0] != WINDOW])
