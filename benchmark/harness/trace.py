"""Reduce a torch.profiler trace of the traced units to what the per-layer
metrics read.

Device time comes from the trace's device events (kernels, copies and
fills).  The busy time is the union of their intervals; the idle share is 1
minus the busy time over the host-clock span of the traced units, which
ends in a synchronize (the arithmetic of chip_smoke.py's device_profile).
Each idle gap is named by the innermost host event (a CUDA runtime call,
where only the device is traced) running when the device went idle.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, NamedTuple, Tuple


class Trace(NamedTuple):
    units: int
    window_s: float  # host clock over the traced units
    busy_s: float  # union of device intervals
    device_ops: int  # device events: kernels, copies, fills
    op_seconds: Dict[str, float]  # device seconds by event name, over the window
    idle_gaps: List[Tuple[str, float]]  # the longest gaps, by host operation


def reduce(events, units: int, window_s: float, top: int = 10) -> Trace:
    """`events`: the profiler's FunctionEvents."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us() / 1e6
    busy_us, reach, gaps = 0.0, -math.inf, []
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if reach > -math.inf and start > reach:
            gaps.append((reach, start - reach))
        busy_us += max(end - max(start, reach), 0.0)
        reach = max(reach, end)
    gaps.sort(key=lambda g: -g[1])
    named = [(_host_op_at(host, t0), us / 1e6) for t0, us in gaps[:top]]
    return Trace(units, window_s, busy_us / 1e6, len(dev), dict(by_name), named)


def _host_op_at(host, t: float) -> str:
    """The innermost (latest started) host operation running at time t."""
    best = None
    for e in host:
        r = e.time_range
        if r.start <= t <= r.end and (best is None or r.start > best.time_range.start):
            best = e
    return best.name if best is not None else "(no host operation)"


def breakdown(tr: Trace, top: int = 10) -> dict:
    ops = sorted(tr.op_seconds.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in tr.idle_gaps[:top]]}
