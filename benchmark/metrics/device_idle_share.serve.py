"""The share of the traced render requests' host-clock span in which no
operation ran on the device (harness/trace.py), in %."""


def read(ctx):
    tr = ctx.trace
    if tr.window_s <= 0 or tr.device_ops == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
