"""repro_torch.obs.compute — the compute half of the telemetry spine
(``repro.obs.compute``'s counterpart).

Three layers, as in the reference:

1. **Oracle counters.**  Every oracle site of
   `repro_torch.core.bilevel_problem` / `repro_torch.core.baselines` calls
   `record_oracle(kind)`, which bumps the problem's own counter
   (``problem.oracle_calls``) and a module-wide one
   (`oracle_trace_counts`).  The port runs its rounds eagerly, so a site
   counts every call, where the reference's sites count once per trace.
   The per-round call counts come from the closed-form formulas
   (`c2dfb_oracle_calls`, `mdbo_oracle_calls`, `madsbo_oracle_calls`), and
   `check_structure` pins the two views to each other: a kind the formula
   says is zero must have zero counted calls, a nonzero kind at least one.

2. **FLOPs of one round.**  `round_cost` runs a run's round 0 under
   ``torch.utils.flop_counter.FlopCounterMode`` and counts its FLOPs
   (matrix products, as PyTorch's counter sees them).  These
   FLOPs are NOT XLA's (the reference walks the compiled HLO), and are
   never compared with them.  ``hbm_bytes``, ``collective_bytes`` and
   ``compile_seconds`` have no counterpart here and stay None.

3. **Device memory.**  `memory_peak_bytes` reads the CUDA allocator's
   high-water mark on the card and returns None on the CPU, as the
   reference returns None where its backend has no allocator stats.
   Machine-dependent: parity-excluded.

Oracle taxonomy (``ORACLE_KINDS``) — by the variable differentiated:
``ul_grad`` (w.r.t. the upper-level x), ``ll_grad`` (w.r.t. a lower-level
y or z; C2DFB's y-loop objective h = f + lam*g counts as one), ``hvp``
((d^2/dy^2 g) @ v) and ``jvp`` ((d^2/dxdy g) @ v).

Per-round, per-node closed forms:

| alg    | ul_grad | ll_grad   | hvp       | jvp |
|--------|---------|-----------|-----------|-----|
| c2dfb  | 3       | 2*(K+1)   | 0         | 0   |
| mdbo   | 1       | K+1       | neumann_N | 1   |
| madsbo | 1       | K+1       | Q         | 1   |
"""

from __future__ import annotations

import dataclasses

import torch

#: every oracle kind an engine may account — `record_oracle` rejects
#: anything else so a typo'd tag cannot silently split a count
ORACLE_KINDS = ("ul_grad", "ll_grad", "hvp", "jvp")

#: module-wide oracle call counters (every problem's calls together)
_ORACLE_SITES: dict[str, int] = {}


def record_oracle(kind: str, n: int = 1, counter: dict | None = None) -> None:
    """Count ``n`` oracle calls of ``kind`` in the module-wide counters and
    in ``counter`` (a problem's ``oracle_calls``) when given."""
    if kind not in ORACLE_KINDS:
        raise ValueError(f"unknown oracle kind {kind!r}; have {ORACLE_KINDS}")
    _ORACLE_SITES[kind] = _ORACLE_SITES.get(kind, 0) + int(n)
    if counter is not None:
        counter[kind] = counter.get(kind, 0) + int(n)


def oracle_trace_counts() -> dict[str, int]:
    """Snapshot of the module-wide per-kind oracle call counters."""
    return dict(_ORACLE_SITES)


def reset_oracle_trace_counts() -> None:
    _ORACLE_SITES.clear()


def oracle_site_delta(before: dict[str, int]) -> dict[str, int]:
    """Calls counted since ``before`` (a prior `oracle_trace_counts`
    snapshot), nonzero entries only."""
    out = {}
    for k, v in _ORACLE_SITES.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


# ---------------------------------------------------------------------------
# closed-form per-round per-node oracle counts
# ---------------------------------------------------------------------------


def c2dfb_oracle_calls(cfg) -> dict[str, int]:
    """C2DFB (Algorithm 1): `refresh_tracker` + K `inner_apply` gradient
    evaluations for each of the y and z loops, then `hyper_grad`'s three
    x-partials.  Fully first-order: hvp = jvp = 0 by construction."""
    return {"ul_grad": 3, "ll_grad": 2 * (int(cfg.K) + 1), "hvp": 0, "jvp": 0}


def mdbo_oracle_calls(cfg) -> dict[str, int]:
    """MDBO: K LL gossip-GD gradients + the grad_y f Neumann seed, one
    hvp per Neumann term, one cross jvp, one grad_x f."""
    return {"ul_grad": 1, "ll_grad": int(cfg.K) + 1, "hvp": int(cfg.neumann_N), "jvp": 1}


def madsbo_oracle_calls(cfg) -> dict[str, int]:
    """MA-DSBO: K LL gradients + the grad_y f HIGP target, one hvp per
    HIGP subsolver step, one cross jvp, one grad_x f."""
    return {"ul_grad": 1, "ll_grad": int(cfg.K) + 1, "hvp": int(cfg.Q), "jvp": 1}


ORACLE_FORMULAS = {
    "c2dfb": c2dfb_oracle_calls,
    "mdbo": mdbo_oracle_calls,
    "madsbo": madsbo_oracle_calls,
}


def oracle_calls_for(alg: str, cfg, m: int = 1, rounds: int = 1) -> dict[str, int]:
    """The closed-form count scaled to ``m`` nodes and ``rounds`` rounds —
    what the round records (``m`` nodes, 1 round) carry."""
    fn = ORACLE_FORMULAS.get(alg)
    if fn is None:
        raise ValueError(f"no oracle formula for {alg!r}; have {tuple(ORACLE_FORMULAS)}")
    return {k: v * int(m) * int(rounds) for k, v in fn(cfg).items()}


def structure_consistent(expected: dict[str, int], sites: dict[str, int]) -> bool:
    """Do counted oracle calls agree with a closed-form count's STRUCTURE?
    A kind the formula makes zero must have zero calls (the
    C2DFB-has-no-hvp claim), a nonzero kind at least one.  Multiplicities
    are not compared."""
    for kind in ORACLE_KINDS:
        want = int(expected.get(kind, 0))
        have = int(sites.get(kind, 0))
        if (want == 0) != (have == 0):
            return False
    return True


def check_structure(label: str, expected: dict[str, int], sites: dict[str, int]) -> None:
    """Raise if a round body's counted oracle calls contradict the
    closed-form formula (see `structure_consistent`)."""
    if not structure_consistent(expected, sites):
        raise ValueError(
            f"{label}: counted oracle calls {sites} are structurally "
            f"inconsistent with the closed-form counts {expected} — an "
            "oracle moved without its formula (or vice versa)"
        )


# ---------------------------------------------------------------------------
# one round body's FLOPs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundCost:
    """One round body's cost: ``flops`` of the whole node-stacked body (all
    m nodes) as ``FlopCounterMode`` counts them; the reference's XLA
    quantities have no counterpart here and are None."""

    flops: float
    hbm_bytes: float | None = None
    collective_bytes: float | None = None
    compile_seconds: float | None = None


def reset_cost_cache() -> None:
    """The reference's memo reset.  The port keeps no memo (every run
    counts its own first round, see `round_cost`), so there is nothing to
    reset."""


def round_cost(
    fn,
    *args,
    expected_oracles: dict[str, int] | None = None,
    label: str = "round",
):
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and return its
    result with the `RoundCost` of that call, after checking the oracle
    calls it made against ``expected_oracles`` (`check_structure`).

    The reference lowers a round without running it; the port counts a
    round it runs anyway (a run's round 0).  The counter only observes the
    operators, so the round computes what it computes without it, and its
    oracle calls count as the run's own."""
    from torch.utils.flop_counter import FlopCounterMode

    before = oracle_trace_counts()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    if expected_oracles is not None:
        check_structure(label, expected_oracles, oracle_site_delta(before))
    return out, RoundCost(flops=float(counter.get_total_flops()))


def memory_peak_bytes(device=None) -> int | None:
    """The CUDA allocator's high-water mark on ``device`` (None on the CPU
    or without a card).  Machine-dependent: parity-excluded."""
    if device is None or torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(device))
