"""K6b (the surfel composite's backward, csrc/rasterize2d_bwd.cu): the
least time its work needs on the card over its traced time, in %.

The least time of each traced step is the larger of its operations over
the float32 peak and its bytes over the memory rate (work/counts.py:
surfel_backward), from the live pairs that reference/ counts on the step's
view.  Its time is the sum of the trace's events of that kernel, matched by
name here, demangled or mangled."""

import re

from benchmark.work import counts

NAME = re.compile(r"rasterize2d_bwd_kernel<\d+>|rasterize2d_bwd_kernelILi\d+E")


def read(ctx):
    seconds = sum(s for n, s in ctx.trace.op_seconds.items() if NAME.search(n))
    if seconds <= 0:
        return None
    least = sum(counts.least_seconds(*counts.surfel_backward(w["live"], w["visible"],
                                                             w["pixels"], w["channels"]))
                for w in ctx.work)
    return 100.0 * least / seconds
