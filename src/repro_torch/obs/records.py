"""The one per-round record schema every execution path emits
(``repro.obs.records``'s counterpart: the same schema, so a JSONL line of
the port and one of the reference compare field for field).

Before this module the repo had four private metric surfaces (the sync
run's stacked dict, the async engine's rows, the `StalenessLedger`, the
device transport's rows).  They now all produce THIS record, built by
`round_record` — so a JSONL line from an eager run, a compiled run and a
transport run can be compared field-for-field.

Record kinds:

``round``      one outer round, the schema below (one line per round);
``node``       one NODE's view of one outer round (schema v2): per-node
               consensus distance, egress bytes, staleness — emitted
               ALONGSIDE the fleet ``round`` row, never instead of it,
               so every v1 consumer keeps working unchanged;
``heartbeat``  a mid-scan liveness sample from a scan-resident host
               callback (subset of the round fields — whatever is
               computable inside the scan; both the compiled async
               runtime and the synchronous `c2dfb.run` scan emit these);
``timing``     a host wall-clock span (compile, scan, bench repetition);
``gate``       a benchmark summary row the regression gate
               (`repro_torch.obs.report`) checks against ``BENCH_async.json``
               / ``BENCH_transport.json``.

Round-record fields (absent signals are None, never missing keys):

| field              | type        | meaning                              |
|--------------------|-------------|--------------------------------------|
| schema             | int         | record schema version (`SCHEMA_VERSION`) |
| kind               | str         | "round"                              |
| run                | str         | caller-chosen run label              |
| engine             | str         | producing engine (`ENGINES`)         |
| round              | int         | outer round index t                  |
| hypergrad_norm     | float       | ||mean_i u_i||                       |
| x_consensus_err    | float       | upper-level consensus error          |
| sx_consensus_err   | float       | tracker consensus error              |
| y_consensus_err    | float       | y inner-loop consensus error         |
| y_compress_err     | float       | y residual compression error         |
| z_consensus_err    | float       | z inner-loop consensus error         |
| measured_bytes     | int         | in-scan codec-metered node bytes     |
| wire_bytes         | int         | per-link priced / executed bytes     |
| bytes_by_stream    | dict        | wire bytes split {outer, y, z}       |
| staleness_max      | int         | max edge age this round              |
| staleness_mean     | float       | mean edge age this round             |
| staleness_hist     | list[int]   | edge-age histogram (len = depth)     |
| sim_seconds        | float       | simulated wall clock of the round    |
| wall_seconds       | float       | HOST wall clock (machine-dependent)  |
| trace_counts       | dict        | per-body jit trace counters snapshot |
| oracle_calls       | dict        | fleet-wide per-kind oracle calls this |
|                    |             | round ({ul_grad, ll_grad, hvp, jvp}; |
|                    |             | closed-form, schema v3)              |
| compute_flops      | float       | trip-count-aware FLOPs of the round  |
|                    |             | body (fleet-wide, schema v3)         |
| hbm_bytes          | float       | dot operand/output bytes — the HBM   |
|                    |             | traffic proxy (fleet-wide, v3)       |
| compile_seconds    | float       | host seconds the cost lowering +     |
|                    |             | compile took (round 0 only, v3)      |
| memory_peak_bytes  | int         | device allocator high-water mark     |
|                    |             | (round 0 only; None on CPU, v3)      |

Node-record fields (schema v2; absent signals are None, never missing):

| field              | type        | meaning                              |
|--------------------|-------------|--------------------------------------|
| schema / kind / run / engine / round    as the round record (kind="node") |
| node               | int         | node index i                         |
| x_dist             | float       | ||x_i - x_bar|| (consensus distance) |
| node_bytes         | int         | payload bytes i emitted, counted     |
|                    |             | ONCE per message (codec truth;       |
|                    |             | executed backends)                   |
| wire_bytes         | int         | i's wire egress, counted once per    |
|                    |             | directed edge (degree-weighted; the  |
|                    |             | fleet row's wire_bytes is the sum    |
|                    |             | over nodes)                          |
| bytes_by_stream    | dict        | {outer, y, z} split of node_bytes    |
|                    |             | when present, else of wire_bytes     |
| staleness_max      | int         | max age over i's incident edges      |
| staleness_mean     | float       | mean age over i's incident edges     |
| compute_flops      | float       | i's share of the round-body FLOPs    |
|                    |             | (fleet compute_flops / m, schema v3) |

Parity contract: `parity_view` drops the machine- and path-dependent
fields (`PARITY_EXCLUDED`) so eager / compiled / transport runs on the
same seed can be asserted row-for-row equal on everything that is a
claim about the ALGORITHM (bytes, staleness, errors, simulated time)
rather than about the host that ran it.

SCHEMA VERSIONS.  v2 adds the ``node`` record kind and stamps every
record ``schema: 2``; the round/heartbeat/timing/gate record KEYS are
unchanged from v1, and `parity_rows` defaults to ``kind="round"`` — so
every schema-v1 parity view / diff over fleet rows produces identical
results on v2 streams (asserted for the reference in tests/test_obs).  v3 (this module)
adds the COMPUTE fields (`COMPUTE_FIELDS` + ``oracle_calls``; see
`repro_torch.obs.compute`): deterministic ones (``oracle_calls``,
``compute_flops``, ``hbm_bytes``) participate in parity, the
machine-dependent pair (``compile_seconds``, ``memory_peak_bytes``)
joins ``wall_seconds`` in `PARITY_EXCLUDED`.  Records that never
carried the new keys (v1/v2 streams) parity-view and diff exactly as
before — the new fields are additive and excluded-or-absent
(asserted for the reference in tests/test_compute_meter).
"""

from __future__ import annotations

from typing import Any

import numpy as np

SCHEMA_VERSION = 3

#: engine labels the shipped paths emit (callers may add their own)
ENGINES = (
    "sync",
    "async-eager",
    "async-compiled",
    "baseline-eager",
    "baseline-compiled",
    "transport-device",
)

#: scalar metric fields lifted verbatim from an engine's per-round row
METRIC_FIELDS = (
    "hypergrad_norm",
    "x_consensus_err",
    "sx_consensus_err",
    "y_consensus_err",
    "y_compress_err",
    "z_consensus_err",
    "measured_bytes",
    "wire_bytes",
    "staleness_max",
    "staleness_mean",
    "sim_seconds",
)

#: scalar metric fields lifted verbatim from a per-node row (schema v2;
#: ``compute_flops`` joined in v3)
NODE_FIELDS = (
    "x_dist",
    "node_bytes",
    "wire_bytes",
    "staleness_max",
    "staleness_mean",
    "compute_flops",
)

#: schema-v3 compute fields carried by round records (kwargs of
#: `round_record`, not METRIC_FIELDS: engines pass them beside the
#: metrics row, like ``bytes_by_stream``).  The first two are
#: deterministic (parity-visible); the last two are host facts.
COMPUTE_FIELDS = (
    "compute_flops",
    "hbm_bytes",
    "compile_seconds",
    "memory_peak_bytes",
)

#: fields that are about the HOST / the producing path, not the
#: algorithm — excluded from cross-engine parity comparison.  The
#: schema-v3 compute partition: ``oracle_calls`` / ``compute_flops`` /
#: ``hbm_bytes`` are claims about the ALGORITHM and stay parity-visible;
#: ``compile_seconds`` / ``memory_peak_bytes`` are claims about the host
#: and land here beside ``wall_seconds``.
PARITY_EXCLUDED = (
    "run",
    "engine",
    "wall_seconds",
    "trace_counts",
    "compile_seconds",
    "memory_peak_bytes",
)


def _host(v: Any) -> Any:
    """A torch tensor (on any device) as a numpy array, floats widened to
    f32 at least (numpy has no bf16); anything else as is."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() and v.element_size() < 4 else v).numpy()
    return v


def _scalar(v: Any) -> Any:
    if v is None:
        return None
    v = np.asarray(_host(v))
    if v.dtype.kind in "iub":
        return int(v)
    return float(v)


def _scalar_or_list(v: Any) -> Any:
    """Heartbeat fields may be per-node vectors (e.g. ``x_node_dist``);
    keep scalars scalar and flatten anything else to a plain list."""
    if v is None:
        return None
    arr = np.asarray(_host(v))
    if arr.ndim == 0:
        return _scalar(arr)
    return [_scalar(x) for x in arr.reshape(-1)]


def round_record(
    engine: str,
    run: str,
    round_idx: int,
    row: dict,
    *,
    bytes_by_stream: dict | None = None,
    wall_seconds: float | None = None,
    trace_counts: dict | None = None,
    oracle_calls: dict | None = None,
    compute_flops: float | None = None,
    hbm_bytes: float | None = None,
    compile_seconds: float | None = None,
    memory_peak_bytes: int | None = None,
) -> dict:
    """One round's record from an engine metrics row (missing metrics
    become explicit None so every record carries the full schema)."""
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "round",
        "run": run,
        "engine": engine,
        "round": int(round_idx),
    }
    for k in METRIC_FIELDS:
        rec[k] = _scalar(row.get(k))
    hist = row.get("staleness_hist")
    rec["staleness_hist"] = (
        [int(c) for c in np.asarray(_host(hist)).reshape(-1)]
        if hist is not None else None
    )
    rec["bytes_by_stream"] = (
        {k: int(v) for k, v in bytes_by_stream.items()}
        if bytes_by_stream is not None else None
    )
    rec["wall_seconds"] = (
        float(wall_seconds) if wall_seconds is not None else None
    )
    rec["trace_counts"] = dict(trace_counts) if trace_counts else None
    # schema-v3 compute fields (see repro_torch.obs.compute): fleet-wide
    # per-round oracle calls and round-body cost; None where a path has
    # no meter (e.g. obs-less runs re-emitted from stacked metrics)
    rec["oracle_calls"] = (
        {k: int(v) for k, v in oracle_calls.items()}
        if oracle_calls is not None else None
    )
    rec["compute_flops"] = (
        float(compute_flops) if compute_flops is not None else None
    )
    rec["hbm_bytes"] = float(hbm_bytes) if hbm_bytes is not None else None
    rec["compile_seconds"] = (
        float(compile_seconds) if compile_seconds is not None else None
    )
    rec["memory_peak_bytes"] = (
        int(memory_peak_bytes) if memory_peak_bytes is not None else None
    )
    return rec


def node_record(
    engine: str,
    run: str,
    round_idx: int,
    node: int,
    row: dict,
    *,
    bytes_by_stream: dict | None = None,
) -> dict:
    """One node's view of one outer round (schema v2, ``kind="node"``).
    Emitted ALONGSIDE the fleet round record — v1 consumers filtering on
    ``kind="round"`` never see these rows."""
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "node",
        "run": run,
        "engine": engine,
        "round": int(round_idx),
        "node": int(node),
    }
    for k in NODE_FIELDS:
        rec[k] = _scalar(row.get(k))
    rec["bytes_by_stream"] = (
        {k: int(v) for k, v in bytes_by_stream.items()}
        if bytes_by_stream is not None else None
    )
    return rec


def node_rows(
    records: list[dict], engine: str | None = None, round_idx: int | None = None
) -> list[dict]:
    """The ``kind="node"`` records, optionally filtered by engine / round,
    ordered (round, node) — the node-resolved companion to `parity_rows`."""
    rows = [
        r for r in records
        if r.get("kind") == "node"
        and (engine is None or r.get("engine") == engine)
        and (round_idx is None or r.get("round") == round_idx)
    ]
    return sorted(rows, key=lambda r: (r.get("round", 0), r.get("node", 0)))


def heartbeat_record(
    engine: str, run: str, round_idx: int, fields: dict
) -> dict:
    """A mid-scan liveness sample (compiled runtime host callback):
    whatever per-round scalars are computable inside the scan."""
    return {
        "schema": SCHEMA_VERSION,
        "kind": "heartbeat",
        "run": run,
        "engine": engine,
        "round": int(round_idx),
        **{k: _scalar_or_list(v) for k, v in fields.items()},
    }


def timing_record(
    run: str,
    label: str,
    seconds: float,
    *,
    engine: str | None = None,
    **extra: Any,
) -> dict:
    """A host wall-clock span (compile, scan, bench repetition)."""
    return {
        "schema": SCHEMA_VERSION,
        "kind": "timing",
        "run": run,
        "engine": engine,
        "label": label,
        "wall_seconds": float(seconds),
        **extra,
    }


def gate_record(
    run: str,
    policy: str,
    *,
    wire_bytes: int,
    trace_counts: dict | None = None,
    warm_wall_s: float | None,
    config: dict,
    oracle_calls: dict | None = None,
    compute_flops: float | None = None,
    compile_seconds: float | None = None,
    memory_peak_bytes: int | None = None,
) -> dict:
    """A benchmark gate row — the unit `repro_torch.obs.report --gate` compares
    against the committed ``BENCH_async.json`` / ``BENCH_transport.json``
    baseline.  ``trace_counts`` is None for backends without a jit trace
    meter (the device transport's eager loop) — the gate then only pins
    bytes and wall clock.  Schema v3 adds the compute block:
    ``oracle_calls`` (whole run, all nodes) and ``compute_flops`` are
    exact gate checks; ``compile_seconds`` / ``memory_peak_bytes`` are
    advisory (machine facts, reported but never failed on)."""
    return {
        "schema": SCHEMA_VERSION,
        "kind": "gate",
        "run": run,
        "policy": policy,
        "wire_bytes": int(wire_bytes),
        "trace_counts": (
            dict(trace_counts) if trace_counts is not None else None
        ),
        "warm_wall_s": float(warm_wall_s) if warm_wall_s is not None else None,
        "config": dict(config),
        "oracle_calls": (
            {k: int(v) for k, v in oracle_calls.items()}
            if oracle_calls is not None else None
        ),
        "compute_flops": (
            float(compute_flops) if compute_flops is not None else None
        ),
        "compile_seconds": (
            float(compile_seconds) if compile_seconds is not None else None
        ),
        "memory_peak_bytes": (
            int(memory_peak_bytes) if memory_peak_bytes is not None else None
        ),
    }


def parity_view(record: dict) -> dict:
    """The record minus host-/path-dependent fields — what cross-engine
    parity tests compare row-for-row (see module docstring)."""
    return {k: v for k, v in record.items() if k not in PARITY_EXCLUDED}


def parity_rows(records: list[dict], kind: str = "round") -> list[dict]:
    """Parity views of all ``kind`` records, in emission order."""
    return [parity_view(r) for r in records if r.get("kind") == kind]
