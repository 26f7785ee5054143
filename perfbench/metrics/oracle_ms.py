"""Device milliseconds a round launched inside the program's
``repro_torch/oracle`` spans (the oracles: the inner loops' gradients and the
hypergradient's three x-partials, with any tracing of them)."""

from perfbench import spans


def read(ctx):
    return spans.layer_ms(ctx, "oracle")
