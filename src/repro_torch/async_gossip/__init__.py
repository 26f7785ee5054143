"""repro_torch.async_gossip — event-driven asynchronous gossip with
staleness-aware mixing (``repro.async_gossip``'s counterpart, the eager
engine).

* ``scheduler`` — `AsyncScheduler`: per-node clocks, per-message arrivals
  (NIC egress + link model + stragglers), and the sync / bounded-staleness
  / fully-async gating policies and version rules.  Produces per-step
  per-edge version AGES.  Host numpy.
* ``mixing``   — delayed gossip on the device: reference-point histories,
  the symmetric age-gated operator that preserves the paper's
  mean-dynamics invariant (Eq. 7) under any delay pattern, and the
  staleness-adaptive damping policies (``DAMPING_POLICIES``).
* ``engine``   — `run_async` (C2DFB rounds under staleness, reached via
  ``c2dfb.run(async_mode=...)``, composing with topology schedules) and
  `run_baseline_async` (MADSBO / MDBO value-gossip loops under the same
  scheduler).  Zero-age rounds take the synchronous path (a branch on the
  host ages), so they are bit-identical to sync.
* ``ledger``   — `StalenessLedger`: per-edge age histograms and the
  consensus-error-vs-simulated-seconds curves.

The reference's compiled runtime (``run_async_compiled``,
``run_baseline_async_compiled``) is not ported yet.
"""

from repro_torch.async_gossip.engine import (
    analytic_message_bytes,
    async_c2dfb_round,
    async_inner_loop,
    baseline_masked_round,
    c2dfb_masked_round,
    c2dfb_schedule_round,
    cached_jit,
    delayed_value_scan,
    record_trace,
    reset_trace_counts,
    run_async,
    run_baseline_async,
    trace_counts,
)
from repro_torch.async_gossip.ledger import (
    LoopRecord,
    StalenessLedger,
    edge_age_samples,
    replay_staleness_rows,
    staleness_stats,
)
from repro_torch.async_gossip.mixing import (
    DAMPING_POLICIES,
    damp_weights,
    damping_factor,
    deterministic_ages,
    init_history,
    mix_delta_delayed,
    push_history,
    required_depth,
    validate_damping,
)
from repro_torch.async_gossip.scheduler import (
    ACK_BYTES,
    POLICIES,
    VERSION_RULES,
    AsyncScheduler,
    AsyncTimeline,
    RoundTimeline,
)

__all__ = [
    "ACK_BYTES",
    "DAMPING_POLICIES",
    "POLICIES",
    "VERSION_RULES",
    "AsyncScheduler",
    "AsyncTimeline",
    "LoopRecord",
    "RoundTimeline",
    "StalenessLedger",
    "analytic_message_bytes",
    "async_c2dfb_round",
    "async_inner_loop",
    "baseline_masked_round",
    "c2dfb_masked_round",
    "c2dfb_schedule_round",
    "cached_jit",
    "damp_weights",
    "damping_factor",
    "delayed_value_scan",
    "deterministic_ages",
    "edge_age_samples",
    "init_history",
    "mix_delta_delayed",
    "push_history",
    "record_trace",
    "replay_staleness_rows",
    "required_depth",
    "reset_trace_counts",
    "run_async",
    "run_baseline_async",
    "staleness_stats",
    "trace_counts",
    "validate_damping",
]
