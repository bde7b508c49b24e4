"""Profiler trace annotations.

Port of `gsplat_tpu/utils/trace.py` (upstream gsplat's NVTX helpers):
`trace_push`, `trace_pop`, `trace_range` and `trace_function` with the
same API, on `torch.profiler.record_function`.  The ranges show in a
`torch.profiler` trace on either device, and as NVTX ranges (for nsys)
under `torch.autograd.profiler.emit_nvtx()`; nothing here calls
`torch.cuda.nvtx` itself, which a CPU build of torch may lack.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch

_stack: list = []


def trace_push(name: str) -> None:
    """Push a named trace region (pair with trace_pop)."""
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    _stack.append(rf)


def trace_pop() -> None:
    """Pop the most recent trace region."""
    if not _stack:
        return
    _stack.pop().__exit__(None, None, None)


@contextlib.contextmanager
def trace_range(name: str):
    """Context manager tracing a region."""
    with torch.profiler.record_function(name):
        yield


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
