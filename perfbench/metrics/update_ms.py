"""Device milliseconds a round launched inside the program's
``repro_torch/update`` spans (the inner loops' and the outer loop's
state-update chains)."""

from perfbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "update")
