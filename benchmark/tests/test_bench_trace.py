"""The traced run's reading of the profiler's events: device operations
against host spans, the ranges the spans leave on the device's timeline
kept out, busy and idle time in the window."""

import pytest
import torch

import bench_tiny  # noqa: F401  (puts the benchmark on the path)
from harness import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start_ms, dur_ms, annotation=False):
        self._n, self._d, self._s, self._t, self._a = name, device, start_ms, dur_ms, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._s * 1e6)

    def duration_ns(self):
        return int(self._t * 1e6)

    def is_user_annotation(self):
        return self._a


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_read_keeps_device_operations_and_host_spans():
    events = [
        Event("bench/window", CPU, 100, 100),
        Event("bench/pack", CPU, 100, 40),
        Event("bench/pack", CUDA, 100, 40),          # the span's range on the device
        Event("program_range", CUDA, 100, 90, annotation=True),
        Event("bench/step", CPU, 140, 10),
        Event("packed_tp_bwd_edge_kernel", CUDA, 130, 30),
        Event("packed_tp_fwd_kernel", CUDA, 150, 20),
        Event("Memcpy HtoD", CUDA, 180, 5),
        Event("early_kernel", CUDA, 10, 5),          # before the window
    ]
    t = trace.read(Prof(events))
    assert t.window_s == pytest.approx(0.1)
    assert sorted(n for n, _a, _b in t.ops) == ["Memcpy HtoD", "packed_tp_bwd_edge_kernel",
                                                  "packed_tp_fwd_kernel"]
    assert t.busy_s() == pytest.approx(0.045)
    assert t.busy_within(0.0, 0.04) == pytest.approx(0.01)
    assert t.op_seconds(("packed_tp_bwd",)) == pytest.approx(0.03)
    assert t.span_at(0.02) == "pack" and t.span_at(0.045) == "step" and t.span_at(0.09) == "other"
    gaps = t.breakdown()["idle_gaps"]
    assert sum(s for _n, s in gaps) == pytest.approx(0.1 - 0.045)
    assert gaps[0][0].startswith("pack")


def test_a_trace_without_one_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.read(Prof([Event("k", CUDA, 0, 1)]))
