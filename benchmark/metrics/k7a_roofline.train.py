"""K7a (the ray composite, csrc/rasterize_eval3d_fwd.cu): the least time
its work needs on the card over its traced time, in %.

The least time of each traced step is the larger of its operations over
the float32 peak and its bytes over the memory rate (work/eval3d.py:
composite_forward), from the live pairs that reference/gut3d.py counts on
the step's view.  Its time is the sum of the trace's events of that kernel,
matched by name here, demangled or mangled; a trace without it reads
nothing."""

import re

from benchmark.work import counts, eval3d

NAME = re.compile(r"rasterize_eval3d_fwd_kernel")


def read(ctx):
    seconds = sum(s for n, s in ctx.trace.op_seconds.items() if NAME.search(n))
    if seconds <= 0:
        return None
    least = sum(counts.least_seconds(*eval3d.composite_forward(w["live"], w["visible"],
                                                               w["pixels"], w["channels"]))
                for w in ctx.work)
    return 100.0 * least / seconds
