"""repro_torch.obs — the telemetry spine (``repro.obs``'s counterpart).

One instrumentation layer the port's runs feed (the synchronous
`repro_torch.core.c2dfb.run`, the async engine and the device transport's
``transport-device`` rows), with the reference's record schema, so the two
packages' JSONL runs compare field for field:

* ``sink``     — `MetricsSink` protocol + `MemorySink` / `JsonlSink`
  (one streamed JSON line per record) / `SocketSink` (the same lines
  over TCP / Unix socket to a live dashboard, non-blocking with
  drop-and-count backpressure) / `MultiSink`, plus the live-safe
  readers `read_jsonl` (``.truncated`` flag) and `follow_jsonl`;
* ``records``  — THE per-round record schema (`round_record`,
  `parity_view`), with per-NODE round rows (`node_record`,
  ``kind="node"``) emitted alongside the fleet aggregates;
* ``watch``    — ``python -m repro_torch.obs.watch``: terminal dashboard
  attached to a SocketSink (``--listen``) or a tailed JSONL file;
* ``core``     — `Obs`, the handle a run takes as ``obs=``, with
  host-span recording and the every-N-rounds `scan_heartbeat`;
* ``timeline`` — `merged_chrome_trace`: the fabric's simulated
  `NetTrace` lanes and the host wall spans in ONE Perfetto export;
* ``report``   — ``python -m repro_torch.obs.report``: summarize a JSONL
  run, diff two runs, and gate a run against a committed baseline;
* ``compute``  — the compute meter: oracle call counters + closed-form
  per-round `oracle_calls`, one round's FLOPs by PyTorch's
  ``FlopCounterMode`` (`round_cost`; never compared with the reference's
  XLA FLOPs), and the device's peak memory.
"""

from repro_torch.obs.compute import (
    ORACLE_FORMULAS,
    ORACLE_KINDS,
    RoundCost,
    c2dfb_oracle_calls,
    check_structure,
    madsbo_oracle_calls,
    mdbo_oracle_calls,
    memory_peak_bytes,
    oracle_calls_for,
    oracle_trace_counts,
    record_oracle,
    reset_cost_cache,
    reset_oracle_trace_counts,
    round_cost,
    structure_consistent,
)
from repro_torch.obs.core import Obs, as_obs, scan_heartbeat
from repro_torch.obs.records import (
    COMPUTE_FIELDS,
    ENGINES,
    METRIC_FIELDS,
    NODE_FIELDS,
    PARITY_EXCLUDED,
    SCHEMA_VERSION,
    gate_record,
    heartbeat_record,
    node_record,
    node_rows,
    parity_rows,
    parity_view,
    round_record,
    timing_record,
)
from repro_torch.obs.sink import (
    JsonlSink,
    MemorySink,
    MetricsSink,
    MultiSink,
    SocketSink,
    follow_jsonl,
    iter_jsonl,
    json_safe,
    read_jsonl,
    sink_from_spec,
)
from repro_torch.obs.timeline import (
    HostSpan,
    HostSpans,
    flops_lane_events,
    merged_chrome_trace,
    node_lane_events,
    save_merged_trace,
)

__all__ = [
    "COMPUTE_FIELDS",
    "ENGINES",
    "METRIC_FIELDS",
    "NODE_FIELDS",
    "ORACLE_FORMULAS",
    "ORACLE_KINDS",
    "PARITY_EXCLUDED",
    "SCHEMA_VERSION",
    "HostSpan",
    "HostSpans",
    "JsonlSink",
    "MemorySink",
    "MetricsSink",
    "MultiSink",
    "Obs",
    "RoundCost",
    "SocketSink",
    "as_obs",
    "c2dfb_oracle_calls",
    "check_structure",
    "flops_lane_events",
    "follow_jsonl",
    "gate_record",
    "heartbeat_record",
    "iter_jsonl",
    "json_safe",
    "madsbo_oracle_calls",
    "mdbo_oracle_calls",
    "memory_peak_bytes",
    "merged_chrome_trace",
    "node_lane_events",
    "node_record",
    "node_rows",
    "oracle_calls_for",
    "oracle_trace_counts",
    "parity_rows",
    "parity_view",
    "read_jsonl",
    "record_oracle",
    "reset_cost_cache",
    "reset_oracle_trace_counts",
    "round_cost",
    "round_record",
    "save_merged_trace",
    "scan_heartbeat",
    "sink_from_spec",
    "structure_consistent",
    "timing_record",
]
