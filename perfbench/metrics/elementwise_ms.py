"""Device milliseconds a round in elementwise, copy, fill, memcpy, memset
and reduction kernels: the inner loop's and the outer loop's updates, the
mixing's casts and the wire metering's counts."""

from perfbench.metrics._device import seconds_by_class


def read(ctx):
    seconds, n = seconds_by_class(ctx.trace, "elementwise")
    return seconds * 1e3 / ctx.trace.rounds if n else None
