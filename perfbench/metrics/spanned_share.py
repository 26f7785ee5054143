"""The share of the traced rounds' device time launched inside one of the
program's layer spans (``repro_torch/oracle`` ... ``repro_torch/stats``), in
%: what the per-layer span metrics account for."""

from perfbench import spans


def read(ctx):
    return spans.spanned_share(ctx)
