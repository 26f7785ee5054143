"""Merged Perfetto timelines: simulated network lanes + host wall spans
(``repro.obs.timeline``'s counterpart).

The fabric's `repro_torch.net.trace.NetTrace` records SIMULATED time (link
latency, stragglers, staleness); the engines' host spans record REAL
time (jit compile, the one-scan execute, per-round dispatch).  The two
clocks answer different questions — "why is the algorithm waiting" vs
"why is my benchmark slow" — and before this module they lived in
different files.  `merged_chrome_trace` joins them into ONE Chrome /
Perfetto trace-event list: simulated lanes under ``sim:*`` process
names, host spans under ``host``, each clock starting at its own zero,
so a single ``ui.perfetto.dev`` load shows simulated staleness drifting
node lanes apart right above the compile/scan cost of producing it.

`layer` marks the port's layers on the profiler's own clock: under
``torch.profiler`` each layer's span is a host range of the profiler's, which
it records beside the launch records and the device activities they start.
The span names (``ROUND`` ... ``STATS``) are the vocabulary that the
benchmark's per-layer readers look for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

#: the port's layer spans, each opened in the shared function where its
#: work is launched: one C2DFB round, an oracle call, the tracing of an
#: oracle's gradient (inside an oracle call), a gossip mix, a state-update
#: chain, an inner transmission's compression, the wire metering, and the
#: round's statistics
ROUND = "repro_torch/round"
ORACLE = "repro_torch/oracle"
ORACLE_TRACE = "repro_torch/oracle_trace"
MIX = "repro_torch/mix"
UPDATE = "repro_torch/update"
COMPRESS = "repro_torch/compress"
METER = "repro_torch/meter"
STATS = "repro_torch/stats"

_NULL = contextlib.nullcontext()


def layer(name: str):
    """A span named ``name`` while a profiler records; otherwise one shared
    null context.  The span is a function-scope range (``_RecordFunctionFast``):
    a host record alone, where ``torch.profiler.record_function``'s user scope
    would also add a device record over its kernels' extent to the profile's
    device activities.  It dispatches no operator, so ``make_fx`` traces none,
    and it never synchronises, reads a device value or allocates on the
    device.  No span opens while a CUDA graph captures, since a replay would
    not repeat it: a replayed round is one span around the replay."""
    if _profiler_enabled() and not (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()):
        return _RecordFunctionFast(name)
    return _NULL


@dataclasses.dataclass(frozen=True)
class HostSpan:
    """One named host wall-clock interval, seconds relative to the
    recorder's epoch (its construction time)."""

    name: str
    t_start: float
    t_end: float

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


class HostSpans:
    """Append-only host span recorder (perf_counter clock, epoch at
    construction).  Thread-safe enough for the shipped use: spans are
    recorded from the driving thread, heartbeat callbacks never write."""

    def __init__(self) -> None:
        self.epoch = time.perf_counter()
        self.spans: list[HostSpan] = []

    def now(self) -> float:
        return time.perf_counter() - self.epoch

    def add(self, name: str, t_start: float, t_end: float) -> HostSpan:
        sp = HostSpan(name=name, t_start=t_start, t_end=t_end)
        self.spans.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str):
        """Record a wall span; under a profiler also a `layer` span."""
        t0 = self.now()
        try:
            with layer(name):
                yield
        finally:
            self.add(name, t0, self.now())

    def total(self, name: str) -> float:
        return sum(s.seconds for s in self.spans if s.name == name)


def _meta(pid: Any, name: str) -> dict:
    return {
        "ph": "M", "name": "process_name", "pid": pid,
        "args": {"name": name},
    }


def node_lane_events(
    records: list[dict], pid: str = "nodes"
) -> list[dict]:
    """Schema-v2 ``kind="node"`` records as per-node Perfetto COUNTER
    lanes: one tid per (engine, node), counter series for the node's
    consensus distance and cumulative wire egress, sampled at the fleet
    round's cumulative simulated seconds (falling back to the round
    index when the run carries no sim clock).  Merge these into the
    Chrome trace via ``merged_chrome_trace(..., node_records=records)``
    and the per-node lanes land right under the fabric's simulated
    transfer lanes."""
    rounds: dict[tuple, dict] = {}
    for r in records:
        if r.get("kind") == "round":
            rounds[(r.get("engine"), r.get("round"))] = r
    # cumulative sim clock per engine, in round order
    clock: dict[tuple, float] = {}
    for eng in {e for e, _ in rounds}:
        t_acc = 0.0
        for key in sorted(
            (k for k in rounds if k[0] == eng), key=lambda k: k[1]
        ):
            sim = rounds[key].get("sim_seconds")
            t_acc += float(sim) if sim is not None else 1.0
            clock[key] = t_acc
    out: list[dict] = []
    egress: dict[tuple, int] = {}
    seen_engines = set()
    for r in records:
        if r.get("kind") != "node":
            continue
        eng, t, i = r.get("engine"), r.get("round"), r.get("node")
        seen_engines.add(eng)
        ts = clock.get((eng, t), float(t or 0) + 1.0) * 1e6
        tid = f"{eng}/node{i}"
        args: dict = {}
        if r.get("x_dist") is not None:
            args["x_dist"] = r["x_dist"]
        if r.get("wire_bytes") is not None:
            key = (eng, i)
            egress[key] = egress.get(key, 0) + int(r["wire_bytes"])
            args["wire_bytes_cum"] = egress[key]
        if args:
            out.append(
                {
                    "name": tid, "ph": "C", "pid": pid, "tid": tid,
                    "ts": ts, "args": args,
                }
            )
    if out:
        out.append(_meta(pid, f"{pid} (per-node, simulated seconds)"))
    return out


def flops_lane_events(
    records: list[dict], pid: str = "compute"
) -> list[dict]:
    """Schema-v3 compute meter as Perfetto COUNTER lanes: one tid per
    engine, cumulative ``compute_flops`` and cumulative total
    ``oracle_calls`` sampled at the fleet round's cumulative simulated
    seconds (round index when the run carries no sim clock) — the
    compute twin of `node_lane_events`' wire-egress counters.  Runs
    whose records predate schema v3 produce no events."""
    out: list[dict] = []
    cum_f: dict[str, float] = {}
    cum_oc: dict[str, int] = {}
    clock: dict[str, float] = {}
    for r in sorted(
        (r for r in records if r.get("kind") == "round"),
        key=lambda r: (r.get("engine") or "", r.get("round") or 0),
    ):
        eng = r.get("engine") or "?"
        sim = r.get("sim_seconds")
        clock[eng] = clock.get(eng, 0.0) + (
            float(sim) if sim is not None else 1.0
        )
        args: dict = {}
        if r.get("compute_flops") is not None:
            cum_f[eng] = cum_f.get(eng, 0.0) + float(r["compute_flops"])
            args["compute_flops_cum"] = cum_f[eng]
        if r.get("oracle_calls"):
            cum_oc[eng] = cum_oc.get(eng, 0) + sum(
                int(v) for v in r["oracle_calls"].values()
            )
            args["oracle_calls_cum"] = cum_oc[eng]
        if args:
            tid = f"{eng}/flops"
            out.append(
                {
                    "name": tid, "ph": "C", "pid": pid, "tid": tid,
                    "ts": clock[eng] * 1e6, "args": args,
                }
            )
    if out:
        out.append(_meta(pid, f"{pid} (FLOPs/oracles, simulated seconds)"))
    return out


def merged_chrome_trace(
    trace=None,
    spans: HostSpans | None = None,
    sim_prefix: str = "sim:",
    host_pid: str = "host",
    node_records: list[dict] | None = None,
) -> list[dict]:
    """One Chrome/Perfetto event list from a `NetTrace` (simulated lanes,
    pids namespaced under ``sim_prefix``) and a `HostSpans` recorder
    (wall lanes under ``host_pid``).  Either side may be None.  The two
    clocks are independent (both start at their own zero); the process
    names make which-is-which explicit in the UI.  ``node_records``
    (a record list holding schema-v2 ``kind="node"`` rows) adds per-node
    counter lanes (`node_lane_events`) on the simulated clock, plus the
    schema-v3 FLOPs/oracle counter lanes (`flops_lane_events`) when the
    same list's round rows carry the compute meter."""
    out: list[dict] = []
    if trace is not None:
        events = (
            trace if isinstance(trace, list) else trace.to_chrome_trace()
        )
        pids = set()
        for ev in events:
            ev = dict(ev)
            ev["pid"] = f"{sim_prefix}{ev['pid']}"
            pids.add(ev["pid"])
            out.append(ev)
        for pid in sorted(pids):
            out.append(_meta(pid, f"{pid} (simulated seconds)"))
    if spans is not None and spans.spans:
        for i, sp in enumerate(spans.spans):
            out.append(
                {
                    "name": sp.name,
                    "ph": "X",
                    "pid": host_pid,
                    "tid": "wall",
                    "ts": sp.t_start * 1e6,
                    "dur": sp.seconds * 1e6,
                }
            )
        out.append(_meta(host_pid, f"{host_pid} (wall seconds)"))
    if node_records:
        out.extend(node_lane_events(node_records))
        out.extend(flops_lane_events(node_records))
    return out


def save_merged_trace(
    path: str,
    trace=None,
    spans: HostSpans | None = None,
    **kw: Any,
) -> list[dict]:
    """Write the merged trace to ``path`` (load in ui.perfetto.dev or
    chrome://tracing); returns the event list."""
    events = merged_chrome_trace(trace, spans, **kw)
    with open(path, "w") as fh:
        json.dump(events, fh)
    return events
