"""Device milliseconds a round launched inside the program's
``repro_torch/compress`` spans (each inner transmission's residual, its
draws and B1 or B4)."""

from perfbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "compress")
