"""Device milliseconds a round launched inside the program's
``repro_torch/mix`` spans (the gossip: the mixes' products and their
casts)."""

from perfbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "mix")
