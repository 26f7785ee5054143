"""The port's layer spans (`repro_torch.obs.timeline.layer`) and the
benchmark's reading of them (`perfbench/spans.py`), on the CPU.

* One C2DFB round under the profiler opens one ``round`` span and, inside
  it, one span a mix, compression, metering and oracle call, none inside
  another.
* With the profiler off a span is one shared null context, and no traced
  oracle gradient holds a profiler op, with the profiler off or on.
* The trace counter grows with the first round's traces and not with a
  second round's.
* The run-level spans (``scan``, ``cost_analysis``) land on the profiler's
  clock too.
* `perfbench/spans.py` sends each device activity, through its launch
  record, to the innermost span on the launching thread.
"""

import contextlib
import importlib
import sys
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import c2dfb as P
from repro_torch.core import topology as ptopo
from repro_torch.data import bilevel_tasks as ptasks
from repro_torch.obs import compute, timeline

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import spans  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

TASK = dict(m=4, n=80, p=12, c=3, h=0.5, seed=0)
K = 3
LAYERS = {timeline.ORACLE, timeline.ORACLE_TRACE, timeline.MIX, timeline.UPDATE, timeline.COMPRESS, timeline.METER,
          timeline.STATS}


def _bundle():
    return ptasks.coefficient_tuning_task(**TASK, device="cpu")


def _cfg(compressor):
    return P.C2DFBConfig(K=K, compressor=compressor, comp_block=128)


def _host_spans(prof):
    """(name, start, end, thread) of every span the profiler recorded."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not e.name().startswith("aten::"):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
    return out


def _inside(a, b):
    """Span a lies within span b (same thread)."""
    return a[3] == b[3] and b[1] <= a[1] and a[2] <= b[2]


@pytest.mark.parametrize("compressor", ["kernel_topk", "kernel_quant"])
def test_a_round_opens_one_span_a_layer_call(compressor):
    b, topo, cfg = _bundle(), ptopo.ring(TASK["m"]), _cfg(compressor)
    gen = torch.Generator().manual_seed(0)
    state = P.init_state(b.problem, cfg, b.x0, b.y0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        P.c2dfb_round(state, gen, b.problem, topo, cfg)
    recorded = _host_spans(prof)
    count = {n: sum(1 for s in recorded if s[0] == n) for n in LAYERS | {timeline.ROUND}}
    assert count[timeline.ROUND] == 1
    assert count[timeline.MIX] == 2 + 4 * K
    assert count[timeline.COMPRESS] == 4 * K
    # each message's count, and the round's sum of the two loops' bytes
    assert count[timeline.METER] == 4 * K + 1
    assert count[timeline.ORACLE] == 2 * K + 3
    assert count[timeline.ORACLE_TRACE] == 0  # init_state traced every oracle of these shapes
    assert count[timeline.UPDATE] == 2 + 2 + 2 * 4 * K
    assert count[timeline.STATS] == 3
    (rnd,) = [s for s in recorded if s[0] == timeline.ROUND]
    layers = [s for s in recorded if s[0] in LAYERS]
    assert all(_inside(s, rnd) for s in layers)
    for a in layers:
        for c in layers:
            if a is not c and _inside(a, c):
                assert (a[0], c[0]) == (timeline.ORACLE_TRACE, timeline.ORACLE), (a, c)


def _profiler_ops(problem):
    return [str(n.target) for tr in problem.graphs._traces.values() for n in tr.module.graph.nodes
            if "profiler" in str(n.target)]


@pytest.mark.parametrize("profiled", [False, True])
def test_no_span_inside_a_traced_oracle(profiled):
    b = _bundle()
    if not profiled:
        assert timeline.layer(timeline.ROUND) is timeline.layer(timeline.MIX)
        assert isinstance(timeline.layer(timeline.ROUND), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext() as prof:
        if profiled:
            assert isinstance(timeline.layer(timeline.ROUND), torch._C._profiler._RecordFunctionFast)
        cfg = _cfg("kernel_topk")
        P.init_state(b.problem, cfg, b.x0, b.y0)
    assert b.problem.graphs.traces > 0
    assert _profiler_ops(b.problem) == []
    if profiled:
        recorded = _host_spans(prof)
        traces = [s for s in recorded if s[0] == timeline.ORACLE_TRACE]
        assert len(traces) == b.problem.graphs.traces
        assert all(any(_inside(t, o) for o in recorded if o[0] == timeline.ORACLE) for t in traces)


def test_the_trace_counter_grows_once():
    b, topo, cfg = _bundle(), ptopo.ring(TASK["m"]), _cfg("kernel_quant")
    gen = torch.Generator().manual_seed(0)
    before = compute.oracle_graph_traces()
    state, _ = P.c2dfb_round(P.init_state(b.problem, cfg, b.x0, b.y0), gen, b.problem, topo, cfg)
    first = compute.oracle_graph_traces()
    assert first["graphs"] - before["graphs"] == b.problem.graphs.traces > 0
    assert first["seconds"] - before["seconds"] == pytest.approx(b.problem.graphs.trace_seconds)
    assert b.problem.graphs.trace_seconds > 0
    P.c2dfb_round(state, gen, b.problem, topo, cfg)
    assert compute.oracle_graph_traces() == first


def test_run_level_spans_land_on_the_profilers_clock():
    b, topo, cfg = _bundle(), ptopo.ring(TASK["m"]), _cfg("kernel_topk")
    handle = obs.Obs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        P.run(b.problem, topo, cfg, b.x0, b.y0, 2, device="cpu", obs=handle)
    recorded = _host_spans(prof)
    (scan,) = [s for s in recorded if s[0] == "scan"]
    (cost,) = [s for s in recorded if s[0] == "cost_analysis"]
    rounds = [s for s in recorded if s[0] == timeline.ROUND]
    assert len(rounds) == 2 and _inside(cost, scan) and all(_inside(r, scan) for r in rounds)
    assert [s.name for s in handle.hostspans.spans] == ["cost_analysis", "scan"]


# ---------------------------------------------------------------- perfbench/spans.py


def _trace():
    """Spans on two threads (an oracle_trace inside an oracle on thread 1),
    launch records, an aten record that shares a launch's correlation id, a
    launch outside every span of its thread and an activity with no launch
    record.  Two rounds."""
    host = [
        ("repro_torch/round", 0, 1000, 0, 1),
        ("repro_torch/mix", 100, 300, 0, 1),
        ("repro_torch/update", 400, 600, 0, 1),
        ("repro_torch/oracle", 650, 900, 0, 1),
        ("repro_torch/oracle_trace", 700, 800, 0, 1),
        ("repro_torch/compress", 0, 500, 0, 2),
        ("repro_torch/meter", 600, 700, 0, 2),
        ("aten::mm", 150, 250, 8, 1),  # an operator's id, not a launch: must not place c8 in mix
    ]
    launch = {1: (150, 1), 2: (450, 1), 3: (720, 1), 4: (850, 1), 5: (950, 1), 6: (100, 2), 7: (650, 2), 8: (800, 2)}
    host += [("cudaLaunchKernel", t, t + 5, corr, tid) for corr, (t, tid) in launch.items()]
    device = [
        ("k_mix", 1000, 1100, 1),
        ("k_update", 1100, 1300, 2),
        ("k_traced", 1300, 1400, 3),
        ("k_oracle", 1400, 1700, 4),
        ("k_round", 1700, 1750, 5),
        ("topk_kernel", 2000, 2400, 6),
        ("k_meter", 2400, 2500, 7),
        ("k_outside", 2500, 2600, 8),
        ("k_unlaunched", 3000, 3100, 99),
    ]
    return Trace(rounds=2, window_s=1e-5, device=device, host=host)


def test_perfbench_spans_innermost_by_thread():
    tr = _trace()
    got = dict(zip((d[0] for d in tr.device), spans.innermost(tr)))
    assert got == {
        "k_mix": "repro_torch/mix", "k_update": "repro_torch/update", "k_traced": "repro_torch/oracle_trace",
        "k_oracle": "repro_torch/oracle", "k_round": "repro_torch/round", "topk_kernel": "repro_torch/compress",
        "k_meter": "repro_torch/meter", "k_outside": None, "k_unlaunched": spans.NO_LAUNCH,
    }
    assert spans.idle_by_span(tr) == {"repro_torch/compress": 250e-9, spans.NO_LAUNCH: 400e-9}


def test_perfbench_span_metrics():
    ctx = types.SimpleNamespace(trace=_trace())
    read = {name: importlib.import_module(f"perfbench.metrics.{name}").read(ctx)
            for name in ("oracle_ms", "mix_ms", "update_ms", "compress_ms", "meter_ms", "stats_ms", "spanned_share")}
    ms = 1e-6 / 2  # ns a round, in ms
    assert read["oracle_ms"] == pytest.approx(400 * ms)
    assert read["mix_ms"] == pytest.approx(100 * ms)
    assert read["update_ms"] == pytest.approx(200 * ms)
    assert read["compress_ms"] == pytest.approx(400 * ms)
    assert read["meter_ms"] == pytest.approx(100 * ms)
    assert read["stats_ms"] is None  # no stats span in the trace
    assert read["spanned_share"] == pytest.approx(100 * 1200 / 1450)
    # no span of the program at all (the parent's trace): every reader None
    bare = types.SimpleNamespace(trace=Trace(rounds=2, window_s=1e-5, device=_trace().device,
                                             host=[h for h in _trace().host if not h[0].startswith("repro_torch/")]))
    assert spans.layer_ms(bare, "mix") is None and spans.spanned_share(bare) is None
