"""B4's (the stochastic quantizer's) share of its memory bound, in %: each
launch reads the node-stacked leaf and its samples (one a padded block
entry, in the leaf's dtype) once and writes the dequantized copy once."""

from perfbench.metrics._device import roofline


def read(ctx):
    if ctx.compressor != "kernel_quant":
        return None
    leaf_bytes = []
    for n, size in ctx.compressed:
        padded = ctx.nodes * -(-(n // ctx.nodes) // ctx.block) * ctx.block
        leaf_bytes.append((2 * n + padded) * size)
    return roofline(ctx, "b4", leaf_bytes)
