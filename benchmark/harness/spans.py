"""Attribute a traced window's device timeline to the program's spans.

The program records named spans and counters in memory while a recording is
open (`gsplat_tpu_torch.utils.trace.recording`; the adapter opens it, since
it alone imports the program).  This module joins three things of the same
traced window:

  * each device operation of the profiler's trace (kernels, copies, fills);
  * the runtime call that launched it (`cudaLaunchKernel`, `cuLaunchKernel`
    for a Triton or driver-API launch, `cudaMemcpyAsync`, ...), found by the
    correlation id the two share;
  * the innermost (latest started) span open at that call's start.  The
    spans' clock is the profiler's host clock (`time.time_ns()`,
    CLOCK_REALTIME on Linux), so a span's times are placed on the trace by
    subtracting the trace's start.  The trace cannot name the launching
    thread (a device-only trace gives every runtime call the same thread
    id), so the span is sought on every thread; only one thread runs the
    program at a time (the main thread waits in `backward` while autograd's
    device thread runs), so it is the launching thread's innermost span.

Each instant of the window goes to one span: while an operation runs, to
the span that launched it (where operations overlap, to the one that
started first); while the device is idle, to the span that launched the
operation ending the gap, which is what the device waited for.  These go to
`other`: a gap between two units (its two operations belong to different
units, or one to none, as at the window's ends), a gap that began while the
host was in the profiler's own `Activity_Buffer_Request`, and operations
launched outside any layer span (in a unit's own span, in `backward`, or
outside every unit).  So the layers and `other` sum to the window.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

# span name -> PERF.md §3's layer; any other span name is `other`
LAYER_OF = {
    "project": "project", "project.sh": "project", "project.bwd": "project",
    "plan": "plan", "sort": "plan",
    "composite": "composite", "composite.bwd": "composite",
    "reduce.bwd": "reduce",
    "loss": "loss", "loss.bwd": "loss",
    "optimizer": "optimizer",
    "strategy": "strategy",
}
LAYERS = ("project", "plan", "composite", "reduce", "loss", "optimizer", "strategy", "other")
# runtime and driver calls that block the host until the device has caught up
SYNC_CALLS = frozenset({
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize", "cuMemcpyDtoH",
    "cuMemcpyDtoH_v2",
})
PROFILER_BUFFER = "Activity_Buffer_Request"
BETWEEN_UNITS, IN_PROFILER, NO_SPAN = "(between units)", "(profiler buffer)", "(no span)"


class Split(NamedTuple):
    units: int  # unit spans that overlap the window
    window_ms: float  # the window per unit
    layer_ms: Dict[str, float]  # LAYERS -> ms a unit; they sum to window_ms
    device_ms_by_span: Dict[str, float]  # device-busy ms a unit, by launching span
    idle_by_span: Dict[str, float]  # idle ms a unit, by the span that ended each gap
    host_syncs_per_unit: float  # SYNC_CALLS issued inside a unit span, a unit
    syncs_by_span: Dict[str, float]  # the same, by the span open at the call
    isect_fill: Optional[float]  # 100 * sum(plan.isects) / sum(plan.capacity)


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    # a span's range on the device's timeline (a CPU-and-CUDA trace) is no operation
    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def _innermost(spans, queries: Sequence[Tuple[float, int]]) -> Dict[int, Optional[int]]:
    """For each query (time µs, key) the position in `spans` (each with
    start, end µs) of the latest-started span open at that time, or None."""
    bounds = []
    for i, (s0, s1) in enumerate(spans):
        bounds.append((s0, 0, i))
        bounds.append((s1, 2, i))
    for t, key in queries:
        bounds.append((t, 1, key))
    bounds.sort(key=lambda b: (b[0], b[1]))
    open_: Dict[int, float] = {}
    out: Dict[int, Optional[int]] = {}
    for t, kind, i in bounds:
        if kind == 0:
            open_[i] = spans[i][0]
        elif kind == 2:
            open_.pop(i, None)
        else:
            out[i] = max(open_, key=lambda j: (open_[j], j)) if open_ else None
    return out


def _launch_spans(dev, host, sp, extra=()):
    """The position in `sp` (span start, end µs) of the innermost span open
    at the launch of each device operation of `dev`, and at each host
    event of `extra`."""
    launch: Dict[int, object] = {}
    for e in host:
        if e.id and (e.id not in launch or e.time_range.start < launch[e.id].time_range.start):
            launch[e.id] = e
    queried = [launch.get(o.id) for o in dev] + list(extra)
    found = _innermost(sp, [(e.time_range.start, n) for n, e in enumerate(queried)
                            if e is not None])
    at = [found.get(n) for n in range(len(queried))]
    return at[:len(dev)], at[len(dev):]


def operation_spans(events: Iterable, spans: Sequence, trace_start_ns: int):
    """(device operation's name, launching span's name or None) of each
    device operation of `events`, in start order."""
    events = list(events)
    dev = sorted((e for e in events if _is_device(e)), key=lambda e: e.time_range.start)
    host = [e for e in events if not _is_device(e)]
    sp = [((s.t0 - trace_start_ns) / 1e3, (s.t1 - trace_start_ns) / 1e3) for s in spans]
    op_span, _ = _launch_spans(dev, host, sp)
    return [(o.name, spans[i].name if i is not None else None) for o, i in zip(dev, op_span)]


def attribute(events: Iterable, spans: Sequence, counters: Sequence, trace_start_ns: int,
              window_us: Optional[Tuple[float, float]] = None) -> Split:
    """`events`: the profiler's FunctionEvents (times in µs from the trace's
    start, `id` the correlation id); `spans` and `counters`: the
    recording's SpanRecords and CounterRecords (times in ns on the trace's
    host clock, whose start is `trace_start_ns`); `window_us`: the traced
    window on the trace's time axis, by default from the first unit's start
    to the last unit's or operation's end."""
    events = list(events)
    dev = sorted((e for e in events if _is_device(e)), key=lambda e: e.time_range.start)
    host = [e for e in events if not _is_device(e)]
    sp = [((s.t0 - trace_start_ns) / 1e3, (s.t1 - trace_start_ns) / 1e3) for s in spans]
    units = [i for i, s in enumerate(spans) if s.parent < 0]
    if window_us is None:
        ends = [sp[i][1] for i in units] + [e.time_range.end for e in dev]
        window_us = (min(sp[i][0] for i in units), max(ends))
    w0, w1 = window_us
    n_units = max(1, sum(1 for i in units if sp[i][1] >= w0 and sp[i][0] <= w1))
    syncs = [e for e in host if e.name in SYNC_CALLS]
    op_span, sync_span = _launch_spans(dev, host, sp, syncs)

    buffers = sorted((e.time_range.start, e.time_range.end) for e in host
                     if e.name == PROFILER_BUFFER)
    starts = [b[0] for b in buffers]

    def in_buffer(t: float) -> bool:
        k = bisect.bisect_right(starts, t)
        return any(buffers[j][0] <= t <= buffers[j][1] for j in range(max(0, k - 4), k))

    layer = collections.defaultdict(float)
    busy = collections.defaultdict(float)
    idle = collections.defaultdict(float)
    name = lambda i: spans[i].name if i is not None else NO_SPAN
    layer_of = lambda i: LAYER_OF.get(spans[i].name, "other") if i is not None else "other"
    unit_of = lambda i: spans[i].unit if i is not None else None
    reach, reach_unit, started = w0, None, False
    for o, si in zip(dev, op_span):
        a, b = max(o.time_range.start, w0), min(o.time_range.end, w1)
        if b <= a:
            continue
        if a > reach:
            gap = a - reach
            if not started or reach_unit is None or unit_of(si) != reach_unit:
                owner, lay = BETWEEN_UNITS, "other"
            elif in_buffer(reach):
                owner, lay = IN_PROFILER, "other"
            else:
                owner, lay = name(si), layer_of(si)
            idle[owner] += gap
            layer[lay] += gap
        if b > reach:
            part = b - max(a, reach)
            busy[name(si)] += part
            layer[layer_of(si)] += part
            reach, reach_unit = b, unit_of(si)
        started = True
    if w1 > reach:
        idle[BETWEEN_UNITS] += w1 - reach
        layer["other"] += w1 - reach

    in_unit = [k for k, e in enumerate(syncs)
               if any(sp[i][0] <= e.time_range.start <= sp[i][1] for i in units)]
    by_sync = collections.Counter(name(sync_span[k]) for k in in_unit)

    isects = sum(c.value for c in counters if c.name == "plan.isects" and c.unit >= 0)
    cap = sum(c.value for c in counters if c.name == "plan.capacity" and c.unit >= 0)
    per = lambda d, scale=1e-3: {k: v * scale / n_units for k, v in
                                 sorted(d.items(), key=lambda kv: -kv[1])}
    return Split(
        units=n_units,
        window_ms=(w1 - w0) / 1e3 / n_units,
        layer_ms={k: layer.get(k, 0.0) / 1e3 / n_units for k in LAYERS},
        device_ms_by_span=per(busy),
        idle_by_span=per(idle),
        host_syncs_per_unit=len(in_unit) / n_units,
        syncs_by_span=per(by_sync, 1.0),
        isect_fill=100.0 * isects / cap if cap > 0 else None,
    )


def breakdown(split: Split, top: int = 12) -> dict:
    """The two breakdown keys: device-busy and idle ms a unit by span."""
    cut = lambda d: [[n[:200], v] for n, v in list(d.items())[:top]]
    return {"device_ms_by_span": cut(split.device_ms_by_span),
            "idle_by_span": cut(split.idle_by_span)}
