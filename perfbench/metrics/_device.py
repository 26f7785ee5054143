"""Sums of the traced window's device time by kernel class, for the
per-layer readers."""

from __future__ import annotations

from perfbench.kernel_classes import classify


def seconds_by_class(trace, cls: str) -> tuple[float, int]:
    """(device seconds, activities) of one class over the traced window."""
    total, n = 0.0, 0
    for name, a, b, _ in trace.device:
        if classify(name) == cls:
            total += (b - a) / 1e9
            n += 1
    return total, n


def roofline(ctx, cls: str, leaf_bytes: list) -> float | None:
    """A compressor kernel's share of its bound, in %: the bytes its
    launches must move (``leaf_bytes`` a launch on each compressed leaf, 4 K
    launches a leaf a round) over the card's memory bandwidth, against the
    device time they took.  None where the trace holds no launch of it or
    not the count the traced rounds make."""
    seconds, n = seconds_by_class(ctx.trace, cls)
    launches = 4 * ctx.K * ctx.trace.rounds
    if n == 0 or n != launches * len(leaf_bytes) or seconds <= 0:
        return None
    return 100.0 * (launches * sum(leaf_bytes) / ctx.hbm_bytes_per_s) / seconds
