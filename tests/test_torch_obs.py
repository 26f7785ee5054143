"""The port's telemetry spine (`repro_torch.obs`) against the JAX
reference's (`repro.obs`): the record builders, sinks, timelines, report
and watch give the reference's output on the same records, and a
synchronous run with ``obs=`` streams the reference's records.

A run's round records parity-view equal to a LIVE reference run's:
integers, oracle calls, simulated seconds, ``compute_flops`` and
``hbm_bytes`` exactly (the reference counts the dots of XLA's compiled
round, the port the matrix products its round runs, with dead code and
round-invariant work gone from its traced oracles), other floats within
the golden tolerance (rtol 1e-4, atol 1e-6).  A run with ``obs`` is bit
for bit the run without it."""

import dataclasses
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core import c2dfb as J
from repro.core import topology as jtopo
from repro.data import bilevel_tasks as jtasks
from repro.net import dynamic as jdyn
from repro.net import fabric as jfab
from repro.net import trace as jtrace
from repro.obs import report as jreport
from repro.obs import watch as jwatch
import repro_torch.obs as pobs
from repro_torch.core import c2dfb as P
from repro_torch.core import topology as ptopo
from repro_torch.core import types as ptypes
from repro_torch.core.convert import from_numpy
from repro_torch.data import bilevel_tasks as ptasks
from repro_torch.net import dynamic as pdyn
from repro_torch.net import fabric as pfab
from repro_torch.net import trace as ptrace
from repro_torch.obs import report as preport
from repro_torch.obs import watch as pwatch

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6
M, TASK = 6, dict(m=6, n=200, p=30, c=3, h=0.5, seed=0)
K, T = 2, 3
# float fields compared exactly: simulated seconds (host numpy on both
# sides) and the counts of a round's matrix products
EXACT_FLOATS = ("sim_seconds", "compute_flops", "hbm_bytes")


def test_obs_exports_the_reference_names():
    assert sorted(pobs.__all__) == sorted(jobs.__all__)
    for name in pobs.__all__:
        assert hasattr(pobs, name)
    for name in ("SCHEMA_VERSION", "ENGINES", "METRIC_FIELDS", "NODE_FIELDS", "COMPUTE_FIELDS", "PARITY_EXCLUDED",
                 "ORACLE_KINDS"):
        assert getattr(pobs, name) == getattr(jobs, name), name


# ---------------------------------------------------------------- builders


def _rows():
    rng = np.random.default_rng(0)
    row = {
        "hypergrad_norm": np.float32(0.5), "x_consensus_err": np.float64(1e-3), "measured_bytes": np.int64(1234),
        "wire_bytes": 999, "sim_seconds": 0.25, "staleness_hist": np.array([3, 1, 0]),
        "staleness_max": np.int32(2), "staleness_mean": np.float32(0.75), "x_node_dist": rng.random(4),
    }
    return row


def test_record_builders_equal_the_reference():
    row = _rows()
    kw = dict(bytes_by_stream={"outer": 10, "y": 20}, wall_seconds=1.5, trace_counts={"sync_scan": 1},
              oracle_calls={"ul_grad": 3, "ll_grad": 6, "hvp": 0, "jvp": 0}, compute_flops=1e6, hbm_bytes=None,
              compile_seconds=None, memory_peak_bytes=None)
    assert pobs.round_record("sync", "r", 2, row, **kw) == jobs.round_record("sync", "r", 2, row, **kw)
    assert pobs.round_record("sync", "r", 0, {}) == jobs.round_record("sync", "r", 0, {})
    node = {"x_dist": np.float32(0.1), "wire_bytes": np.int64(7), "compute_flops": 2.5}
    assert pobs.node_record("sync", "r", 1, 3, node) == jobs.node_record("sync", "r", 1, 3, node)
    assert pobs.heartbeat_record("sync", "r", 4, row) == jobs.heartbeat_record("sync", "r", 4, row)
    assert pobs.timing_record("r", "scan", 0.5, engine="sync", x=1) == jobs.timing_record("r", "scan", 0.5, engine="sync", x=1)
    gkw = dict(wire_bytes=100, trace_counts=None, warm_wall_s=0.2, config={"T": 3},
               oracle_calls={"ul_grad": 1}, compute_flops=3.0, compile_seconds=None, memory_peak_bytes=5)
    assert pobs.gate_record("r", "sync", **gkw) == jobs.gate_record("r", "sync", **gkw)
    recs = [jobs.round_record("sync", "r", t, row, **kw) for t in range(2)]
    recs += [jobs.node_record("sync", "r", t, i, node) for t in range(2) for i in range(3)]
    assert pobs.parity_rows(recs) == jobs.parity_rows(recs)
    assert pobs.parity_rows(recs, kind="node") == jobs.parity_rows(recs, kind="node")
    assert pobs.node_rows(recs, round_idx=1) == jobs.node_rows(recs, round_idx=1)


def test_record_builders_take_torch_tensors():
    """The port's rows hold tensors (any device, bf16 too): they build the
    record the numpy row builds."""
    row = _rows()
    trow = {k: (torch.from_numpy(np.asarray(v)) if k != "wire_bytes" else v) for k, v in row.items()}
    trow["hypergrad_norm"] = torch.tensor(0.5, dtype=torch.bfloat16)
    assert pobs.round_record("sync", "r", 0, trow) == jobs.round_record("sync", "r", 0, row)
    assert pobs.heartbeat_record("sync", "r", 0, trow) == jobs.heartbeat_record("sync", "r", 0, row)


def test_json_safe_accepts_torch_tensors():
    rec = {"a": torch.tensor(3), "b": torch.tensor(float("nan")), "c": torch.arange(3),
           "d": torch.tensor(0.25, dtype=torch.bfloat16), "e": torch.tensor(1.0, dtype=torch.float64),
           "f": np.float32(2.0), "g": [torch.tensor(True)]}
    got = pobs.json_safe(rec)
    assert got == {"a": 3, "b": None, "c": [0, 1, 2], "d": 0.25, "e": 1.0, "f": 2.0, "g": [True]}
    assert isinstance(got["a"], int) and isinstance(got["d"], float)
    json.dumps(got)
    plain = {"f": np.float32(2.0), "n": np.nan, "arr": np.arange(3), "nested": {"x": np.int64(4)}}
    assert pobs.json_safe(plain) == jobs.json_safe(plain)


def test_sinks_write_what_the_reference_writes(tmp_path):
    recs = [jobs.round_record("sync", "r", t, _rows()) for t in range(3)]
    for mod, name in ((jobs, "j"), (pobs, "p")):
        mem = mod.MemorySink()
        with mod.JsonlSink(str(tmp_path / f"{name}.jsonl")) as js:
            multi = mod.MultiSink(mem, js)
            for r in recs:
                multi.emit(r)
        spec = mod.sink_from_spec(f"jsonl:{tmp_path / (name + '2.jsonl')}")
        for r in recs:
            spec.emit(r)
        spec.close()
        assert mem.rows(kind="round") == mem.records and len(mem.records) == 3
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert (tmp_path / "p2.jsonl").read_text() == (tmp_path / "j2.jsonl").read_text()
    assert pobs.read_jsonl(str(tmp_path / "p.jsonl")) == jobs.read_jsonl(str(tmp_path / "j.jsonl"))
    assert list(pobs.iter_jsonl(str(tmp_path / "j.jsonl"))) == list(jobs.iter_jsonl(str(tmp_path / "j.jsonl")))
    assert list(pobs.follow_jsonl(str(tmp_path / "j.jsonl"), timeout_s=0.0)) == jobs.read_jsonl(str(tmp_path / "j.jsonl"))


def test_timelines_equal_the_reference():
    events = []
    for tr_mod, obs_mod in ((jtrace, jobs), (ptrace, pobs)):
        tr = tr_mod.NetTrace()
        tr.add_transfer(tr_mod.TransferEvent(round=0, phase=0, src=0, dst=1, bytes=64, t_start=0.0, t_end=0.01))
        tr.add_phase(tr_mod.PhaseEvent(round=0, phase=0, label="out/x", t_start=0.0, t_end=0.02))
        spans = obs_mod.HostSpans()
        spans.add("scan", 0.5, 1.25)
        recs = [jobs.round_record("sync", "r", t, {"sim_seconds": 0.5 + t}, compute_flops=10.0,
                                  oracle_calls={"ul_grad": 3}) for t in range(2)]
        recs += [jobs.node_record("sync", "r", t, i, {"x_dist": 0.1 * i, "wire_bytes": 8}) for t in range(2) for i in range(2)]
        events.append((obs_mod.merged_chrome_trace(tr, spans, node_records=recs),
                       obs_mod.node_lane_events(recs), obs_mod.flops_lane_events(recs)))
    assert events[1] == events[0]
    span = pobs.HostSpans()
    with span.span("a"):
        pass
    assert span.total("a") >= 0.0 and span.spans[0].name == "a"


# ---------------------------------------------------------------- compute


def test_oracle_formulas_equal_the_reference():
    from repro.core.baselines import MADSBOConfig, MDBOConfig

    for alg, cfg in (("c2dfb", J.C2DFBConfig(K=7)), ("mdbo", MDBOConfig(K=4, neumann_N=3)), ("madsbo", MADSBOConfig(K=5, Q=2))):
        assert pobs.ORACLE_FORMULAS[alg](cfg) == jobs.ORACLE_FORMULAS[alg](cfg)
        assert pobs.oracle_calls_for(alg, cfg, m=10, rounds=3) == jobs.oracle_calls_for(alg, cfg, m=10, rounds=3)
    # the fleet a round of the full-width smoke run: m = 10, K = 10
    assert pobs.oracle_calls_for("c2dfb", J.C2DFBConfig(K=10), m=10) == {"ul_grad": 30, "ll_grad": 220, "hvp": 0, "jvp": 0}
    with pytest.raises(ValueError):
        pobs.oracle_calls_for("f2sa", None)


def test_structure_check_and_counters():
    want = pobs.c2dfb_oracle_calls(J.C2DFBConfig(K=2))
    assert pobs.structure_consistent(want, {"ul_grad": 1, "ll_grad": 9})
    assert not pobs.structure_consistent(want, {"ul_grad": 1, "ll_grad": 9, "hvp": 1})
    assert not pobs.structure_consistent(want, {"ul_grad": 1})
    with pytest.raises(ValueError, match="structurally"):
        pobs.check_structure("c2dfb", want, {"hvp": 2})
    with pytest.raises(ValueError, match="unknown oracle kind"):
        pobs.record_oracle("hessian")
    pobs.reset_oracle_trace_counts()
    counter = {}
    pobs.record_oracle("ll_grad", 2, counter)
    pobs.record_oracle("ul_grad", counter=counter)
    assert counter == pobs.oracle_trace_counts() == {"ll_grad": 2, "ul_grad": 1}
    pobs.reset_oracle_trace_counts()
    assert pobs.oracle_trace_counts() == {}
    assert pobs.memory_peak_bytes() is None and pobs.memory_peak_bytes("cpu") is None


def test_round_cost_counts_flops_once_and_restores_counters():
    """round_cost runs its body once and returns the body's result with its
    FLOPs.  The body is a round the run keeps (round 0), so its oracle calls
    stay counted: nothing is rolled back."""
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    before = pobs.oracle_trace_counts()
    calls = []

    def body(x, y):
        calls.append(1)
        pobs.record_oracle("ul_grad")
        return x @ y

    out, cost = pobs.round_cost(body, a, b, expected_oracles={"ul_grad": 1}, label="t")
    assert len(calls) == 1 and torch.equal(out, a @ b)
    assert cost.flops == 2 * 4 * 8 * 3
    assert cost.hbm_bytes == (4 * 8 + 8 * 3 + 4 * 3) * 4  # both operands and the output, f32
    assert cost.compile_seconds is None
    assert pobs.oracle_trace_counts()["ul_grad"] == before.get("ul_grad", 0) + 1
    with pytest.raises(ValueError, match="structurally"):
        pobs.round_cost(body, a, b, expected_oracles={"hvp": 1}, label="t")
    pobs.reset_cost_cache()  # the reference's name; the port keeps no memo


def test_obs_handle():
    assert pobs.as_obs(None) is None
    sink = pobs.MemorySink()
    o = pobs.as_obs(sink)
    assert isinstance(o, pobs.Obs) and o.sink is sink and pobs.as_obs(o) is o
    with pytest.raises(TypeError):
        pobs.as_obs(3)
    with pytest.raises(ValueError):
        pobs.Obs(heartbeat_every=-1)
    o = pobs.Obs(sink=sink, heartbeat_every=2, run="x")
    for t in range(5):
        pobs.scan_heartbeat(o, "sync", t, {"hypergrad_norm": torch.tensor(float(t))})
    assert [r["round"] for r in sink.rows(kind="heartbeat")] == [0, 2, 4]
    with o.span("scan", engine="sync"):
        pass
    assert sink.rows(kind="timing")[0]["label"] == "scan" and o.hostspans.spans[0].name == "scan"


# ---------------------------------------------------------------- a run with obs


@pytest.fixture(scope="module")
def bundles():
    jb = jtasks.coefficient_tuning_task(**TASK)
    pb = ptasks.coefficient_tuning_task(**TASK, device="cpu")
    return jb, dataclasses.replace(pb, x0=from_numpy(jb.x0), y0=from_numpy(jb.y0))


@pytest.fixture(scope="module")
def obs_runs(bundles):
    """The reference and the port, each run with a fabric, a dropout
    schedule and obs (heartbeat every 2 rounds) on a MemorySink."""
    jb, pb = bundles
    jt, pt = jtopo.ring(M), ptopo.ring(M)
    kw = dict(profile="wan", straggler="lognormal", sigma=0.6, compute_s=0.02, seed=0)
    cfg_kw = dict(K=K, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    jsink, psink = jobs.MemorySink(), pobs.MemorySink()
    js, jm = J.run(
        jb.problem, jt, J.C2DFBConfig(**cfg_kw), jb.x0, jb.y0, T=T, key=jax.random.PRNGKey(0),
        schedule=jdyn.LinkDropoutSchedule(jt, p_drop=0.2, seed=0), fabric=jfab.make_fabric(jt, **kw),
        obs=jobs.Obs(sink=jsink, heartbeat_every=2),
    )
    pb.problem.oracle_calls.clear()
    ps, pm = P.run(
        pb.problem, pt, P.C2DFBConfig(**cfg_kw), pb.x0, pb.y0, T=T, device="cpu",
        schedule=pdyn.LinkDropoutSchedule(pt, p_drop=0.2, seed=0), fabric=pfab.make_fabric(pt, **kw),
        obs=pobs.Obs(sink=psink, heartbeat_every=2),
    )
    return dict(jsink=jsink, psink=psink, jm=jm, pm=pm, calls=dict(pb.problem.oracle_calls), cfg=P.C2DFBConfig(**cfg_kw))


def _assert_rows_match(prow, jrow, what):
    assert set(prow) == set(jrow), what
    for k, jv in jrow.items():
        pv = prow[k]
        floats = isinstance(jv, float) or (isinstance(jv, list) and any(isinstance(v, float) for v in jv))
        if floats and k not in EXACT_FLOATS:
            np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
        else:
            assert pv == jv, (what, k, pv, jv)


def test_round_records_parity_view_equal_the_reference(obs_runs):
    jrows = jobs.parity_rows(obs_runs["jsink"].records)
    prows = pobs.parity_rows(obs_runs["psink"].records)
    assert len(prows) == len(jrows) == T
    for t, (p, j) in enumerate(zip(prows, jrows)):
        _assert_rows_match(p, j, f"round {t}")
        assert p["oracle_calls"] == j["oracle_calls"] == pobs.oracle_calls_for("c2dfb", obs_runs["cfg"], m=M)
        assert p["wire_bytes"] is not None and p["sim_seconds"] is not None
        # the counts at this config (m = 6, n = 200, p = 30, c = 3, K = 2, ring)
        assert p["compute_flops"] == 179_280.0 and p["hbm_bytes"] == 168_048.0
    prec = obs_runs["psink"].rows(kind="round")
    assert prec[0]["memory_peak_bytes"] is None and all(r["compile_seconds"] is None for r in prec)


def test_node_records_equal_the_reference(obs_runs):
    jrows = jobs.parity_rows(obs_runs["jsink"].records, kind="node")
    prows = pobs.parity_rows(obs_runs["psink"].records, kind="node")
    assert len(prows) == len(jrows) == T * M
    flops = obs_runs["psink"].rows(kind="round")[0]["compute_flops"]
    for p, j in zip(prows, jrows):
        _assert_rows_match(p, j, f"node {p['round']}/{p['node']}")
        assert p["compute_flops"] == pytest.approx(flops / M)


def test_record_stream_has_the_reference_shape(obs_runs):
    """Timing spans (cost_analysis, scan), heartbeats on rounds 0 and 2,
    then the round and node records, in the reference's order."""
    order = lambda recs: [(r["kind"], r.get("label"), r.get("round")) for r in recs]  # noqa: E731
    assert order(obs_runs["psink"].records) == order(obs_runs["jsink"].records)
    jh, ph = obs_runs["jsink"].rows(kind="heartbeat"), obs_runs["psink"].rows(kind="heartbeat")
    assert [r["round"] for r in ph] == [0, 2]
    for p, j in zip(ph, jh):
        _assert_rows_match(p, j, "heartbeat")


def test_run_with_obs_counts_the_oracles_of_its_rounds_only(obs_runs):
    """FLOPs are counted on the run's own round 0, with no extra round: the
    problem's counter holds init_state's calls (2 ll_grad, 3 ul_grad) and T
    rounds'."""
    per = pobs.c2dfb_oracle_calls(obs_runs["cfg"])
    assert obs_runs["calls"] == {"ul_grad": 3 + per["ul_grad"] * T, "ll_grad": 2 + per["ll_grad"] * T}


@pytest.mark.parametrize("compressor", ["kernel_topk", "kernel_quant"])
def test_run_with_obs_is_bit_for_bit_the_run_without(bundles, compressor, tmp_path):
    jb, pb = bundles
    pt = ptopo.ring(M)
    cfg = P.C2DFBConfig(K=K, compressor=compressor, comp_ratio=0.2, comp_bits=4, comp_block=128)
    out = []
    for obs in (None, pobs.Obs(sink=pobs.JsonlSink(str(tmp_path / "run.jsonl")), heartbeat_every=1)):
        pb.problem.oracle_calls.clear()
        state, mets = P.run(pb.problem, pt, cfg, pb.x0, pb.y0, T=T, device="cpu",
                            generator=torch.Generator().manual_seed(3), obs=obs)
        out.append((state, mets, dict(pb.problem.oracle_calls)))
        if obs is not None:
            obs.close()
    (s0, m0, c0), (s1, m1, c1) = out
    assert c0 == c1
    trees = lambda s: [s.x, s.s_x, s.u_prev, *s.inner_y, *s.inner_z]  # noqa: E731
    for a, b in zip(trees(s0), trees(s1)):
        for la, lb in zip(ptypes.tree_leaves(a), ptypes.tree_leaves(b)):
            assert torch.equal(la, lb)
    assert set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    recs = pobs.read_jsonl(str(tmp_path / "run.jsonl"))
    assert len([r for r in recs if r["kind"] == "round"]) == T
    assert len([r for r in recs if r["kind"] == "node"]) == T * M


# ---------------------------------------------------------------- the round's matrix products


# (task, the task function's arguments, compressor, compute_flops, hbm_bytes): the
# reference's counts, pinned, at T = 1 on a ring with K = 2
COST_CASES = {
    "coef-identity": ("coef", TASK, "identity", 179_280.0, 168_048.0),
    "coef-topk": ("coef", TASK, "topk", 179_280.0, 168_048.0),
    "coef-kernel_topk": ("coef", TASK, "kernel_topk", 179_280.0, 168_048.0),
    "hyper-identity": ("hyper", dict(m=4, n=200, side=6, hidden=8, c=3, seed=0), "identity", 396_544.0, 250_368.0),
    "hyper-kernel_topk": ("hyper", dict(m=4, n=200, side=6, hidden=8, c=3, seed=0), "kernel_topk", 396_544.0, 250_368.0),
}
BUILDERS = {"coef": (jtasks.coefficient_tuning_task, ptasks.coefficient_tuning_task),
            "hyper": (jtasks.hyper_representation_task, ptasks.hyper_representation_task)}


def _port_bundle(task, kw):
    jb = BUILDERS[task][0](**kw)
    pb = BUILDERS[task][1](**kw, device="cpu")
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return jb, dataclasses.replace(pb, x0=from_numpy(host(jb.x0)), y0=from_numpy(host(jb.y0)))


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_round_cost_equals_the_reference(case):
    """compute_flops and hbm_bytes of a round record equal the reference's
    (XLA's dots of the compiled round) on both paper tasks.  The traces are
    built once per oracle kind, not once per call."""
    task, kw, compressor, flops, nbytes = COST_CASES[case]
    jb, pb = _port_bundle(task, kw)
    m = kw["m"]
    cfg = dict(K=K, compressor=compressor, comp_ratio=0.2, comp_block=128)
    jsink, psink = jobs.MemorySink(), pobs.MemorySink()
    J.run(jb.problem, jtopo.ring(m), J.C2DFBConfig(**cfg), jb.x0, jb.y0, T=1, key=jax.random.PRNGKey(0),
          obs=jobs.Obs(sink=jsink))
    P.run(pb.problem, ptopo.ring(m), P.C2DFBConfig(**cfg), pb.x0, pb.y0, T=2, device="cpu", obs=pobs.Obs(sink=psink))
    j, p = jsink.rows(kind="round")[0], psink.rows(kind="round")[0]
    assert (j["compute_flops"], j["hbm_bytes"]) == (flops, nbytes)
    assert (p["compute_flops"], p["hbm_bytes"]) == (flops, nbytes)
    assert pb.problem.graphs.traces == 4  # h and g in y, f and g in x


def _count_ops(fn):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] = self.ops.get(func.overloadpacket.__name__, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        out = fn()
    return out, count.ops


@pytest.mark.parametrize("task", ["coef", "hyper"])
def test_hyper_grad_runs_no_unread_forward(task):
    """hyper_grad equals the untraced autograd gradient bit for bit, counts 3
    ul_grad oracle calls, and on coefficient tuning runs no bmm at all:
    neither f (no x) nor g (x in the ridge term only) needs its logits."""
    from repro_torch.core.bilevel_problem import grad_of_sum

    kw = TASK if task == "coef" else COST_CASES["hyper-identity"][1]
    _, pb = _port_bundle(task, kw)
    problem, lam = pb.problem, 10.0
    rng = np.random.default_rng(4)
    y = ptypes.tree_map(lambda v: v + torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)), pb.y0)
    z = ptypes.tree_map(lambda v: v * 0.5, y)
    problem.oracle_calls.clear()
    for _ in range(2):  # the second call finds its traces and x's values built
        got, ops = _count_ops(lambda: problem.hyper_grad(pb.x0, y, z, lam))
        if task == "coef":
            assert ops.get("bmm", 0) == 0 and ops.get("mm", 0) == 0, ops
        else:
            assert ops.get("bmm", 0) > 0
    assert problem.oracle_calls == {"ul_grad": 6}
    f, g = problem.f, problem.g
    gfx = grad_of_sum(f, (pb.x0, y, problem.data_f), 0)
    gy, gz = (grad_of_sum(g, (pb.x0, v, problem.data_g), 0) for v in (y, z))
    want = ptypes.tree_map(lambda a, b, c: a + lam * (b - c), gfx, gy, gz)
    for a, b in zip(ptypes.tree_leaves(got), ptypes.tree_leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- report and watch


@pytest.fixture(scope="module")
def ref_jsonl(tmp_path_factory, obs_runs):
    """The reference's records and the port's as JSONL files."""
    d = tmp_path_factory.mktemp("obs")
    paths = {}
    for name, sink in (("ref", obs_runs["jsink"]), ("port", obs_runs["psink"])):
        with jobs.JsonlSink(str(d / f"{name}.jsonl")) as js:
            for r in sink.records:
                js.emit(r)
        paths[name] = str(d / f"{name}.jsonl")
    return paths


def test_report_summarize_and_diff_equal_the_reference(ref_jsonl):
    ref = jobs.read_jsonl(ref_jsonl["ref"])
    port = pobs.read_jsonl(ref_jsonl["port"])
    assert preport.summarize(ref) == jreport.summarize(ref)
    assert preport.summarize(port) == jreport.summarize(port)
    assert preport.to_target_table(ref) == jreport.to_target_table(ref)
    assert preport.diff(ref, port) == jreport.diff(ref, port)
    assert preport.diff(ref, ref) == jreport.diff(ref, ref) and preport.diff(ref, ref)[1]


def test_report_gate_equals_the_reference():
    baseline = json.loads((ROOT / "BENCH_async.json").read_text())
    block = baseline["gate"]
    gates = []
    for pol, g in block["policies"].items():
        gates.append(jobs.gate_record("r", pol, wire_bytes=g["wire_bytes"], trace_counts=g.get("trace_counts"),
                                      warm_wall_s=g.get("warm_wall_s"), config=block["config"],
                                      oracle_calls=g.get("oracle_calls"), compute_flops=g.get("compute_flops")))
    bad = [dict(gates[0], wire_bytes=gates[0]["wire_bytes"] + 1)] + gates[1:]
    for recs in (gates, bad, []):
        assert preport.gate(recs, baseline) == jreport.gate(recs, baseline)
    assert preport.gate(gates, baseline)[1] and not preport.gate(bad, baseline)[1]


def test_report_cli(ref_jsonl, capsys):
    assert preport.main([ref_jsonl["ref"]]) == jreport.main([ref_jsonl["ref"]]) == 0
    preport.main([ref_jsonl["port"], "--diff", ref_jsonl["ref"]])
    out = capsys.readouterr().out
    assert "parity:" in out
    # the module runs as a program
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", ref_jsonl["ref"]], capture_output=True,
                          text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("engine sync: 3 rounds")


def test_watch_renders_the_reference_frame(ref_jsonl):
    recs = jobs.read_jsonl(ref_jsonl["ref"])
    clock = iter(range(10_000)).__next__
    clock2 = iter(range(10_000)).__next__
    ps, js = pwatch.WatchState(clock=clock), jwatch.WatchState(clock=clock2)
    for r in recs:
        ps.ingest(r)
        js.ingest(r)
    pf, jf = ps.render("run.jsonl"), js.render("run.jsonl")
    assert pf.splitlines()[0].startswith("repro_torch.obs.watch")
    assert pf.splitlines()[1:] == jf.splitlines()[1:]
    buf = io.StringIO()
    state = pwatch.watch(iter(recs), source="x", once=True, out=buf)
    assert state.records == len(recs) and "sync" in buf.getvalue()
    assert pwatch.main([ref_jsonl["ref"], "--once"]) == 0
