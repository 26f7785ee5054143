"""Device milliseconds a round launched inside the program's
``repro_torch/stats`` spans (the round's and the inner loops' consensus
and norm statistics)."""

from perfbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "stats")
