"""harness/spans.py on synthetic profiler events: a kernel goes to the
innermost span open at its launch, on any thread, a gap to the span that
launched the operation ending it, a gap between units and one in the
profiler's buffer request to `other`, and the layers with `other` sum to
the window."""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import pytest
from torch.autograd import DeviceType

from benchmark.harness import spans

T0 = 1_000_000_000  # the trace's start, ns on the spans' clock
MAIN, WORKER = 101, 202


class Span(NamedTuple):  # the recording's SpanRecord
    name: str
    index: int
    parent: int
    unit: int
    thread: int
    t0: int
    t1: int


class Counter(NamedTuple):
    name: str
    unit: int
    value: float


def span(name, index, parent, unit, start_us, end_us, thread=MAIN):
    return Span(name, index, parent, unit, thread, T0 + int(start_us * 1e3),
                T0 + int(end_us * 1e3))


def event(name, device, corr, start, end):
    """A FunctionEvent of a device-only trace: every runtime call on thread 1."""
    return SimpleNamespace(name=name, device_type=device, id=corr, thread=1,
                           time_range=SimpleNamespace(start=start, end=end))


def kernel(corr, start, end, launched_at, name="k"):
    """A kernel and the cudaLaunchKernel that launched it (1 µs long)."""
    return [event("cudaLaunchKernel", DeviceType.CPU, corr, launched_at, launched_at + 1),
            event(name, DeviceType.CUDA, corr, start, end)]


def one_unit():
    """train.step [0, 100] > project [0, 30], loss [30, 60], backward
    [60, 100] > composite.bwd [61, 99] on the worker thread."""
    return [span("train.step", 0, -1, 0, 0, 100), span("project", 1, 0, 0, 0, 30),
            span("loss", 2, 0, 0, 30, 60), span("backward", 3, 0, 0, 60, 100),
            span("composite.bwd", 4, 3, 0, 61, 99, WORKER)]


def test_a_kernel_goes_to_the_innermost_span_open_at_its_launch():
    """On any thread: the worker's `composite.bwd` inside the main thread's
    `backward`; a launch in `backward` alone is no layer's."""
    ev = (kernel(1, 10, 20, 5) + kernel(2, 40, 50, 35) + kernel(3, 70, 90, 65, "K2")
          + kernel(4, 90, 95, 60.5))
    s = spans.attribute(ev, one_unit(), [], T0, (10, 95))
    assert s.device_ms_by_span == pytest.approx({"project": 0.010, "loss": 0.010,
                                                 "composite.bwd": 0.020, "backward": 0.005})
    assert s.layer_ms["composite"] == pytest.approx(0.040)  # K2 and the gap 50-70 it ended
    assert s.layer_ms["other"] == pytest.approx(0.005)
    assert spans.operation_spans(ev, one_unit(), T0)[2] == ("K2", "composite.bwd")


def test_a_gap_goes_to_the_span_that_launched_the_operation_ending_it():
    ev = kernel(1, 10, 20, 5) + kernel(2, 45, 50, 44)
    s = spans.attribute(ev, one_unit(), [], T0, (10, 50))
    assert s.idle_by_span == pytest.approx({"loss": 0.025})
    assert s.layer_ms["loss"] == pytest.approx(0.030)
    assert s.layer_ms["project"] == pytest.approx(0.010)


def test_gaps_between_units_and_in_the_profiler_buffer_go_to_other():
    sp = [span("train.step", 0, -1, 0, 0, 100), span("project", 1, 0, 0, 0, 100),
          span("train.step", 2, -1, 2, 100, 200), span("project", 3, 2, 2, 100, 200)]
    ev = (kernel(1, 10, 20, 5) + kernel(2, 40, 50, 35)  # gap 20-40 in the buffer request
          + [event(spans.PROFILER_BUFFER, DeviceType.CPU, 0, 15, 30)]
          + kernel(3, 120, 130, 110)  # gap 50-120 between units
          + kernel(4, 140, 150, 135))  # gap 130-140 in project
    s = spans.attribute(ev, sp, [], T0, (10, 160))
    assert s.units == 2
    assert s.idle_by_span == pytest.approx({spans.BETWEEN_UNITS: (70 + 10) / 2e3,
                                            spans.IN_PROFILER: 20 / 2e3, "project": 10 / 2e3})
    assert s.layer_ms["project"] == pytest.approx((40 + 10) / 2e3)
    assert s.layer_ms["other"] == pytest.approx((70 + 10 + 20) / 2e3)


def test_the_layers_and_other_sum_to_the_window():
    ev = (kernel(1, 10, 20, 5) + kernel(2, 15, 40, 31)  # overlapping: the first keeps 15-20
          + kernel(3, 70, 90, 65) + kernel(7, 95, 99, 200))  # launched after the unit
    ev.append(event("cudaStreamSynchronize", DeviceType.CPU, 9, 60.5, 61))
    counters = [Counter("plan.isects", 0, 30.0), Counter("plan.capacity", 0, 120.0),
                Counter("plan.isects", -1, 50.0)]
    s = spans.attribute(ev, one_unit(), counters, T0, (0, 120))
    assert sum(s.layer_ms.values()) == pytest.approx(s.window_ms) == pytest.approx(0.120)
    assert set(s.layer_ms) == set(spans.LAYERS)
    assert s.host_syncs_per_unit == 1 and s.syncs_by_span == {"backward": 1.0}
    assert s.isect_fill == pytest.approx(25.0)  # counters outside a unit are left out
    out = spans.breakdown(s)
    assert set(out) == {"device_ms_by_span", "idle_by_span"}
