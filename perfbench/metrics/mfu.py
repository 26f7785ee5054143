"""The round's model FLOPs over what the card's peak could do in the traced
round time, in %: the products the round's oracle calls need (the
family's closed form: no recompute, no elementwise work), over
(traced window / rounds) x peak (989 TFLOP/s bf16, 67 TFLOP/s float32
outside the tensor cores; NVIDIA's H100 SXM data sheet)."""


def read(ctx):
    round_s = ctx.trace.window_s / ctx.trace.rounds
    return 100.0 * ctx.flops_per_round / (round_s * ctx.peak_flops) if round_s > 0 else None
