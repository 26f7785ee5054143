"""The MoE, SSM and hybrid configs of lm-test's size (A10b) in the LM
bilevel run against the live JAX reference, in process, as
tests/test_torch_lm_bilevel.py holds the dense one (its helpers): f32
rounds on the reference's states (and the hybrid's in bf16), and each
oracle's FLOPs and dot bytes against XLA's (MoE equal, SSM and hybrid
short by the closed-form gaps of `MAMBA_GAPS`).  About 320 s on one
worker: each config compiles the reference's init state and round in
XLA."""

import pytest

from test_torch_lm_bilevel import (
    ARCHS,
    ATOL,
    B,
    BF16_STEPS,
    HYBRID_TEST,
    M,
    S,
    Pair,
    _bf16_rounds_within_the_bound,
    _f32_rounds_equal,
    _oracle_costs,
    _pair,
)


@pytest.fixture(scope="module", params=list(ARCHS))
def arch_f32(request):
    return _pair("f32", ARCHS[request.param])


@pytest.fixture(scope="module")
def hybrid_bf16():
    return _pair("bf16", HYBRID_TEST)


def _has_mamba(pair: Pair) -> bool:
    return "mamba" in pair.pcfg.pattern


def test_arch_f32_rounds_equal_the_reference_round_by_round(arch_f32, monkeypatch):
    """MoE, SSM and hybrid configs of lm-test's size, f32, T = 2 rounds on
    the reference's states with its selections, within the LM f32 bounds
    above; with Mamba blocks the atol is 5e-6 (times 1 + 2 lam for s_x and
    u), the factor of 5 the model tests state for a Mamba layer's gradient
    (tests/test_torch_models.py: its chunk scan and gated norm carry the
    input projection's reassociation differences into the x-partials).
    The MoE's capacity of max(8, 64 * 2 / 4 * 1.25) = 40 a node drops no
    slot here; the dispatch with drops is held in
    tests/test_torch_ssm_moe.py."""
    _f32_rounds_equal(arch_f32, monkeypatch, atol=5 * ATOL if _has_mamba(arch_f32) else ATOL)


def test_arch_bf16_rounds_within_the_bound_round_by_round(hybrid_bf16, monkeypatch):
    """The hybrid (a Mamba block, attention and a MoE) in bf16, T = 1,
    within 4 times the bf16 bound above (16 bf16 steps of a leaf's scale):
    the reference's jitted round may keep a fusion's bf16 intermediates in
    f32 (XLA's excess precision), the port rounds every operator to bf16,
    and these layers chain more bf16 elementwise steps than an attention
    block (a Mamba layer's conv taps, SiLU and gate: the reference's SiLU
    of the conv differs from the port's by a bf16 step, 0.0156 on 2.58;
    each package's layer is as near an f32 evaluation as the other's, 0.023
    and 0.030 on outputs of 3.26; a MoE's gate products and combine); the
    final norm's y-gradient sums 64 tokens' products of them.  Measured: up
    to 7.8 steps (y_s) on MOE_TEST and 13.4 on this config.  The x-tree
    keeps its mixed dtypes (the Mamba block's f32 a_log, d_skip, dt_bias
    and the f32 router in a bf16 model)."""
    _bf16_rounds_within_the_bound(hybrid_bf16, monkeypatch, rounds=1, steps=4 * BF16_STEPS)


# The reference's counts exceed the port's on a Mamba layer (ROADMAP §C),
# a node, by whole products of three kinds, each (FLOPs, dot bytes) in f32:
# * sP, one chunk's (H, P, N)-sized product, (2 B H P N Q, 4 B H (P Q + Q N
#   + P N)): XLA's scan runs the same body on every chunk, so it computes
#   the last chunk's state product, which nothing reads, in each forward
#   and recompute (1 each; the port's traced graph drops it), and in each
#   backward that product's two cotangent products and the cotangent of the
#   constant zero initial state through the first chunk's y_off (3; the
#   port's autograd carries nothing there);
# * E, the transposes of the reference's elementwise einsum steps, which
#   XLA keeps as contracting dot_generals and the port's autograd takes as
#   multiplies and sums: a chunk's cotangents of new_contrib's dt decay_out
#   and of y_off's decay_in (over N) and of y_diag's dt (over P), (2 B S H
#   (P + 2 N), 4 B S H (4 N + 2 P + 3)) a backward;
# * A, one attention score product, (2 B H S^2 hd, 4 (B H S hd + B KV S hd
#   + B H S^2)): without RoPE (hybrid-test, as jamba) XLA computes the
#   scores again in the attention chunk's own remat nested in the block's
#   recompute (with RoPE, as lm-test, it merges them); the port runs a
#   nested checkpoint plainly inside a recompute.
# An x-partial is a forward, a recompute and a backward; the three
# x-partials share their two data sets' forwards and recomputes, in both.
# (oracle: (sP, E, A)) a node, on SSM_TEST and HYBRID_TEST at B = 2, S = 32
# (2 chunks); MOE_TEST's counts are equal
MAMBA_GAPS = {
    "ssm": {"x-partial of g": (5, 1, 0), "y-gradient of g": (1, 0, 0), "y-gradient of h": (2, 0, 0),
            "hypergradient": (13, 3, 0)},
    "hybrid": {"x-partial of g": (5, 1, 1), "y-gradient of g": (1, 0, 0), "y-gradient of h": (2, 0, 0),
               "hypergradient": (13, 3, 2)},
}


def _mamba_gap_units(cfg) -> tuple:
    """(FLOPs, dot bytes) a node of sP, E and A above (one q-chunk, S <= 1024)."""
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, min(cfg.ssm_chunk, S)
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return ((2 * B * H * P * N * Q, 4 * B * H * (P * Q + Q * N + P * N)),
            (2 * B * S * H * (P + 2 * N), 4 * B * S * H * (4 * N + 2 * P + 3)),
            (2 * B * Hq * S * S * hd, 4 * (B * Hq * S * hd + B * KV * S * hd + B * Hq * S * S)))


def test_arch_oracle_costs_against_the_reference(arch_f32):
    """MoE: every oracle's FLOPs and dot bytes equal XLA's.  SSM and hybrid:
    the reference's exceed the port's by the closed-form gaps above, a
    node."""
    cfg = arch_f32.pcfg
    gaps = MAMBA_GAPS.get(cfg.name.removesuffix("-test"), {})
    units = _mamba_gap_units(cfg)
    for name, ((flops, nbytes), (want_flops, want_bytes)) in _oracle_costs(arch_f32).items():
        n = gaps.get(name, (0, 0, 0))
        assert want_flops - flops == M * sum(c * u[0] for c, u in zip(n, units)), (name, flops, want_flops)
        assert want_bytes - nbytes == M * sum(c * u[1] for c, u in zip(n, units)), (name, nbytes, want_bytes)
