"""Device operations (kernels, copies, fills) the host launched per traced
render request, from the profiler's trace."""


def read(ctx):
    tr = ctx.trace
    if tr.device_ops == 0:
        return None
    return tr.device_ops / tr.units
