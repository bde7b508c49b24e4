"""Profiler trace annotations, and the port's span and counter recorder.

Port of `gsplat_tpu/utils/trace.py` (upstream gsplat's NVTX helpers):
`trace_push`, `trace_pop`, `trace_range` and `trace_function` with the
same API.  While a `torch.profiler` session (or `emit_nvtx()`) is active,
each span enters `torch.profiler.record_function`, so the ranges show in a
trace on either device and as NVTX ranges for nsys; nothing here calls
`torch.cuda.nvtx` itself, which a CPU build of torch may lack.

`recording()` keeps the spans in memory as well, with counters: the way to
split a training step or a served request by layer.  The program opens
these spans (PERF.md §3 names the layer of each):

  * units: `train.step` (`Trainer.run_step`), `serve.request`
    (`scene.render_scene`); a span opened with no open parent starts a unit;
  * forward: `project` (activations, projection) with `project.sh`,
    `plan`, `sort`, `composite`, `loss`;
  * backward: `backward` around `loss.backward()`, inside it `loss.bwd`,
    `composite.bwd`, `reduce.bwd` and `project.bwd`;
  * after it: `optimizer`, `strategy`;
  * counters `plan.isects` (each plan's intersections) and `plan.capacity`
    (the slots its emission and sort are sized for); `project.fused` and
    `project.fused_grad` (the (camera, gaussian) rows the projection pass
    projects without autograd, and on the training route with its backward
    kernel), `project.ut` (the rows through the UT's sigma points).

With no recording open and no profiler active a span costs a check of
those two flags: no object, no timestamp, no hook.  Spans take their
times from `time.time_ns()`, the clock of the profiler's host events on
Linux (CLOCK_REALTIME), so that a trace's launches fall inside the spans
that issued them.  Stacks are per thread: autograd runs a CUDA backward on
its own device thread, where a span with no open parent on that thread
takes the innermost open span of the thread that opened the recording.

Backward over plain PyTorch ops is bounded by gradient hooks
(`backward_phase`), registered only while a recording is open, so that a
step with none builds the graph it always builds.  Counters keep
references to values the program already computes and read them once, when
the recording closes, so nothing waits for the device inside it.
"""

from __future__ import annotations

import array
import contextlib
import functools
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

_profiler_on = torch.autograd._profiler_enabled
_clock = time.time_ns
_NULL = contextlib.nullcontext()
_rec: Optional["Recording"] = None  # the open recording
_tls = threading.local()  # .pushed: trace_push's handles on this thread


class SpanRecord(NamedTuple):
    name: str
    index: int
    parent: int  # -1 for a unit's span
    unit: int  # index of the unit's span
    thread: int  # threading.get_ident() of the thread that opened it
    t0: int  # ns, time.time_ns()
    t1: int


class CounterRecord(NamedTuple):
    name: str
    unit: int  # -1 outside any span
    value: float


class Recording:
    """The spans and counters of one `recording()`: `spans` and `counters`
    (lists of SpanRecord and CounterRecord) once it has closed.  While it
    is open a span is an index into flat arrays, so that recording
    allocates no object that outlives its span (nothing for the garbage
    collector to walk)."""

    def __init__(self) -> None:
        self.spans: List[SpanRecord] = []
        self.counters: List[CounterRecord] = []
        self._name: List[str] = []
        self._parent = array.array("q")
        self._unit = array.array("q")
        self._thread: List[int] = []
        self._t0 = array.array("q")
        self._t1 = array.array("q")
        self._stacks: Dict[int, List[int]] = {}  # thread -> open span indices
        self._root = threading.get_ident()
        self._c_name: List[str] = []
        self._c_unit = array.array("q")
        self._c_value: List[Any] = []
        self._phase = -1

    def __enter__(self) -> "Recording":
        global _rec
        if _rec is not None:
            raise RuntimeError("a recording is open already")
        _rec = self
        return self

    def __exit__(self, *exc) -> None:
        global _rec
        _rec = None
        self._finish()

    def _open(self, name: str) -> int:
        ident = threading.get_ident()
        stack = self._stacks.setdefault(ident, [])
        if stack:
            parent = stack[-1]
        else:
            root = self._stacks.get(self._root) if ident != self._root else None
            parent = root[-1] if root else -1
        i = len(self._name)
        self._name.append(name)
        self._parent.append(parent)
        self._unit.append(i if parent < 0 else self._unit[parent])
        self._thread.append(ident)
        self._t1.append(0)
        stack.append(i)
        self._t0.append(_clock())
        return i

    def _close(self, i: int) -> None:
        t = _clock()
        if self._t1[i]:
            return
        stack = self._stacks[self._thread[i]]
        if len(self._stacks) > 1 or stack[-1] != i:
            # spans opened under this one and still open (a backward phase
            # on autograd's thread, an unpopped push) end with it
            for other in self._stacks.values():
                for j in [j for j in other if j > i and self._under(j, i)]:
                    self._t1[j] = t
                    other.remove(j)
        self._t1[i] = t
        if i in stack:
            stack.remove(i)
        if self._phase >= 0 and self._t1[self._phase]:
            self._phase = -1

    def _under(self, j: int, i: int) -> bool:
        while j > i:
            j = self._parent[j]
        return j == i

    def _current_unit(self) -> int:
        stack = self._stacks.get(threading.get_ident()) or self._stacks.get(self._root)
        return self._unit[stack[-1]] if stack else -1

    def _switch_phase(self, name: str, _grad) -> None:
        if _rec is not self or (self._phase >= 0 and self._name[self._phase] == name):
            return
        if self._phase >= 0:
            self._close(self._phase)
        self._phase = self._open(name)

    def _finish(self) -> None:
        for stack in self._stacks.values():
            for i in list(stack):
                self._close(i)
        self.spans = [SpanRecord(n, i, p, u, th, t0, t1)
                      for i, (n, p, u, th, t0, t1) in enumerate(zip(
                          self._name, self._parent, self._unit, self._thread, self._t0,
                          self._t1))]
        values = [v.item() if isinstance(v, torch.Tensor) else v for v in self._c_value]
        self.counters = [CounterRecord(n, u, float(v))
                         for n, u, v in zip(self._c_name, self._c_unit, values)]
        self._c_value = []


def recording() -> Recording:
    """A context manager recording the spans and counters opened inside its
    block (one recording at a time); it yields the Recording, whose `spans`
    and `counters` are filled when the block ends, reading each counter's
    device value then."""
    return Recording()


def count(name: str, value: Any) -> None:
    """Record `value` (a device scalar the program computes anyway, or a
    host number) under `name` in the open recording's current unit; read
    when the recording closes.  Nothing without a recording."""
    rec = _rec
    if rec is not None:
        rec._c_name.append(name)
        rec._c_unit.append(rec._current_unit())
        rec._c_value.append(value)


def backward_phase(name: str, *tensors) -> None:
    """While a recording is open: when the first gradient of `tensors`
    arrives in backward, the backward span open from an earlier phase ends
    and the span `name` opens, on the thread that runs the backward; it ends
    at the next phase or with its parent (the `backward` span).  Autograd
    runs nodes in the reverse of the order they were made, so a phase that
    starts at a forward boundary holds the backward of what the forward did
    after that boundary.  The hooks return None: gradients are unchanged.
    Without a recording nothing is registered."""
    rec = _rec
    if rec is None:
        return
    hook = functools.partial(rec._switch_phase, name)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            t.register_hook(hook)


class _Range:
    __slots__ = ("name", "rf", "rec", "span")

    def __init__(self, name: str):
        self.name = name
        self.rf = self.rec = None

    def __enter__(self):
        if _profiler_on():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = _rec
        if self.rec is not None:
            self.span = self.rec._open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self.rec is not None:
            self.rec._close(self.span)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)


def trace_range(name: str):
    """Context manager tracing a region: a profiler range while a profiler
    is active, a span of the open recording."""
    if _rec is None and not _profiler_on():
        return _NULL
    return _Range(name)


def trace_push(name: str) -> None:
    """Push a named trace region (pair with trace_pop on the same thread)."""
    r = trace_range(name)
    r.__enter__()
    pushed = getattr(_tls, "pushed", None)
    if pushed is None:
        pushed = _tls.pushed = []
    pushed.append(r)


def trace_pop() -> None:
    """Pop this thread's most recent trace region."""
    pushed = getattr(_tls, "pushed", None)
    if pushed:
        pushed.pop().__exit__(None, None, None)


def trace_function(name: Optional[str] = None) -> Callable:
    """Decorator tracing a function call (name defaults to qualname)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with trace_range(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco
