"""The trace annotations of gsplat_tpu_torch.utils.trace: the JAX helper
API (gsplat_tpu.utils.trace) on torch.profiler.record_function; every
range shows by name in a torch.profiler trace, nested ranges inside their
parent."""

import torch

from gsplat_tpu_torch.utils import trace_function, trace_pop, trace_push, trace_range


def test_trace_ranges_show_in_a_profiler_trace():
    @trace_function()
    def decorated(x):
        return x * 2

    @trace_function("named_fn")
    def named(x):
        return x + 1

    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_range("outer_range"):
            trace_push("pushed_range")
            y = decorated(x) @ x
            trace_pop()
            named(y)
    events = {e.name: e for e in prof.events()}
    for name in ("outer_range", "pushed_range", "named_fn",
                 "test_trace_ranges_show_in_a_profiler_trace.<locals>.decorated"):
        assert name in events, name
    outer, pushed = events["outer_range"].time_range, events["pushed_range"].time_range
    assert outer.start <= pushed.start and pushed.end <= outer.end
    trace_pop()  # an empty stack pops nothing
