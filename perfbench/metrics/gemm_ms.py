"""Device milliseconds a round in matrix products (cuBLAS and CUTLASS GEMM,
GEMV, dot): the oracles' products and the gossip's mixing."""

from perfbench.metrics._device import seconds_by_class


def read(ctx):
    seconds, n = seconds_by_class(ctx.trace, "gemm")
    return seconds * 1e3 / ctx.trace.rounds if n else None
