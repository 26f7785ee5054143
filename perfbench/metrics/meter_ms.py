"""Device milliseconds a round launched inside the program's
``repro_torch/meter`` spans (the wire metering: each message's byte count
and their sums)."""

from perfbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "meter")
