"""The share of the traced window in which no activity ran on the device,
in %: 1 - (union of the device activities' intervals) / window."""


def read(ctx):
    busy = ctx.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.trace.window_s)
