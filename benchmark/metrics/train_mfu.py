"""The whole training step's share of the card's float32 peak, in %: the
least operations of the traced steps (work/counts.py: step_flops, on the
live pairs and visible gaussians that reference/ counts on each step's
view) over the traced span on the host clock times 67 TFLOP/s."""

from benchmark.work import counts


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.work:
        return None
    flops = sum(counts.step_flops(w) for w in ctx.work)
    return 100.0 * flops / (ctx.trace.window_s * counts.PEAK_F32_FLOPS)
