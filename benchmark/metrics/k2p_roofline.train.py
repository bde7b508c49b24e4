"""K2 packed (the training step's composite backward, csrc/rasterize_bwd.cu
with PACKED): the least time its work needs on the card over its traced
time, in %.

The least time of each traced step is the larger of its operations over
the float32 peak and its bytes over the memory rate (work/counts.py:
composite_backward), from the live pairs that reference/ counts on the
step's view.  Its time is the sum of the trace's events of that kernel,
matched by name here: the demangled template with PACKED true, or its
mangled form."""

import re

from benchmark.work import counts

NAME = re.compile(r"rasterize_bwd_kernel<\d+, true>|rasterize_bwd_kernelILi\d+ELb1E")


def read(ctx):
    seconds = sum(s for n, s in ctx.trace.op_seconds.items() if NAME.search(n))
    if seconds <= 0:
        return None
    least = sum(counts.least_seconds(*counts.composite_backward(w["live"], w["visible"],
                                                                w["pixels"], w["channels"]))
                for w in ctx.work)
    return 100.0 * least / seconds
