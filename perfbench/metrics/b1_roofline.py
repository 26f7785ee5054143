"""B1's (the block top-k kernel's) share of its memory bound, in %: each
launch reads the node-stacked leaf once and writes its compressed copy
once."""

from perfbench.metrics._device import roofline


def read(ctx):
    if ctx.compressor != "kernel_topk":
        return None
    return roofline(ctx, "b1", [2 * n * size for n, size in ctx.compressed])
