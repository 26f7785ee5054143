"""The port's compiled asynchronous runtime (`repro_torch.async_gossip.compiled`)
against its own eager engine and against LIVE compiled runs of the JAX
reference (``repro.async_gossip.compiled``), on the CPU.

* The compiled run equals the port's eager ``run_async(payload_bytes=
  "analytic")`` bit for bit: the same round bodies on the same ages (on the
  CPU a loop over the built body; on a card the same bodies replayed from
  CUDA graphs, held bit for bit by chip_smoke.py).
* At the reference's async gate config (benchmarks/bench_async.py) every
  scheduler-derived integer and float equals the reference's compiled run on
  every round; the trajectory agrees within the golden tolerance up to the
  first top-k near-tie (ROADMAP §C), and the measured bytes are equal there.
* Build accounting, heartbeats, the shared body cache and the caller's
  tensors, as tests/test_compiled_async.py holds the reference to them."""

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.async_gossip as PA
import repro_torch.obs as pobs
from repro.async_gossip.compiled import run_async_compiled as j_compiled
from repro.core import c2dfb as J
from repro.net import fabric as jfab
from repro_torch.async_gossip import compiled as pcomp
from repro_torch.async_gossip import engine as peng
from repro_torch.core import baselines as PB
from repro_torch.core import c2dfb as P
from repro_torch.core import topology as ptopo
from repro_torch.data import bilevel_tasks as ptasks
from repro_torch.net import dynamic as pdyn
from repro_torch.net import fabric as pfab
from repro_torch.transport import SimTransport

from _torch_replay import JaxReplay
from test_torch_async import (
    GEO,
    _assert_rows_match,
    _bundles,
    _close,
    _per_step,
    _round_metrics_close,
    _same_ledger,
    _same_schedule_metrics,
)
from test_torch_async_gate import GATE_CFG, GATE_JT, GATE_ROWS, GATE_T, GATE_TASK, GATE_WIRE, TIE, _record_topk_margins

# tests/test_compiled_async.py's bundle, config and fabric
BUNDLE = dict(m=4, n=80, p=12, c=3, h=0.5, seed=0)
CFG = dict(K=3, compressor="topk", comp_ratio=0.3, gamma_in=0.3, eta_in=0.3)
FABRIC = dict(profile="geo", straggler="lognormal", sigma=0.8, compute_s=0.05, seed=1)


@pytest.fixture(scope="module")
def bundle():
    return ptasks.coefficient_tuning_task(**BUNDLE, device="cpu")


def _fabric(topo, **kw):
    return pfab.make_fabric(topo, **{**FABRIC, **kw})


def _assert_bit_equal(st_e, me, st_c, mc):
    """State, every metric and the ledger equal bit for bit."""
    leaves_e, leaves_c = pcomp._tensors(st_e), pcomp._tensors(st_c)
    assert len(leaves_e) == len(leaves_c) and st_e.t == st_c.t
    for a, b in zip(leaves_e, leaves_c):
        assert torch.equal(a, b)
    assert set(me) == set(mc)
    for k in me:
        if k == "ledger":
            continue
        a, b = me[k], mc[k]
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    le, lc = me["ledger"], mc["ledger"]
    for a, b in zip(le.curve(), lc.curve()):
        np.testing.assert_array_equal(a, b)
    assert le.max_age() == lc.max_age() and le.mean_age() == lc.mean_age()
    np.testing.assert_array_equal(le.histogram(), lc.histogram())
    assert [(r.round, r.loop, r.edges, r.t_start, r.t_end) for r in le.loops] == \
        [(r.round, r.loop, r.edges, r.t_start, r.t_end) for r in lc.loops]
    assert all(np.array_equal(a.ages, b.ages) for a, b in zip(le.loops, lc.loops))


# ---------------------------------------------------------------- compiled == eager, bit for bit


def _eager_and_compiled(bundle, run):
    pt = ptopo.ring(4)
    x0, y0, problem = bundle.x0, bundle.y0, bundle.problem
    if run in ("mdbo", "madsbo"):
        bcfg = PB.MADSBOConfig(K=3, Q=2) if run == "madsbo" else PB.MDBOConfig(K=3, neumann_N=2)
        return [peng.run_baseline_async(run, problem, pt, bcfg, x0, y0, 3, _fabric(pt), policy="bounded", bound=1,
                                        device="cpu", compiled=compiled) for compiled in (False, True)]
    cfg = P.C2DFBConfig(**CFG)
    if run == "schedule":
        kw = dict(policy="full", mixing_damping="inverse-age")
        fab = dict(profile="wan", straggler="none", compute_s=0.01)
        sched = lambda: pdyn.BConnectedSchedule(pt, B=2)  # noqa: E731
        eager = peng.run_async(problem, pt, cfg, x0, y0, 4, fabric=_fabric(pt, **fab), schedule=sched(),
                               payload_bytes="analytic", device="cpu", **kw)
        return eager, PA.run_async_compiled(problem, pt, cfg, x0, y0, 4, fabric=_fabric(pt, **fab), schedule=sched(),
                                            device="cpu", **kw)
    policy, bound = {"sync": ("sync", 0), "bounded": ("bounded", 1), "full": ("full", 0)}[run]
    eager = peng.run_async(problem, pt, cfg, x0, y0, 4, fabric=_fabric(pt), policy=policy, bound=bound,
                           payload_bytes="analytic", device="cpu")
    return eager, PA.run_async_compiled(problem, pt, cfg, x0, y0, 4, fabric=_fabric(pt), policy=policy, bound=bound,
                                        device="cpu")


@pytest.mark.parametrize("run", ["sync", "bounded", "full", "schedule", "mdbo", "madsbo"])
def test_compiled_run_is_the_eager_analytic_run_bit_for_bit(bundle, run):
    (st_e, me), (st_c, mc) = _eager_and_compiled(bundle, run)
    _assert_bit_equal(st_e, me, st_c, mc)
    if run in ("full", "schedule"):
        assert int(np.max(mc["staleness_max"])) > 0  # the rounds mixed stale versions


def test_zero_latency_compiled_run_is_the_sync_run_bit_for_bit(bundle):
    """Every age is 0 on a zero-latency fabric, so every round takes the
    synchronous body: the same ops as ``run()``'s rounds.  (The reference's
    own test of this fails under jax 0.9.0, ROADMAP §C: its async body
    compiles to other float ops than its sync scan.)"""
    pt = ptopo.ring(4)
    cfg = P.C2DFBConfig(**CFG)
    s0, m0 = P.run(bundle.problem, pt, cfg, bundle.x0, bundle.y0, T=3, device="cpu")
    s1, m1 = P.run(bundle.problem, pt, cfg, bundle.x0, bundle.y0, T=3, device="cpu", async_mode="full",
                   compiled=True, fabric=pfab.make_fabric(pt, profile="zero", compute_s=0.0, seed=0))
    assert int(m1["staleness_max"].max()) == 0
    for a, b in zip(pcomp._tensors(s0), pcomp._tensors(s1)):
        assert torch.equal(a, b)
    for k, v in m0.items():
        assert torch.equal(v, m1[k]), k


def test_builds_are_constant_in_T(bundle):
    """A run builds the compiled runner and the round body once each,
    whatever T is: the reference's ``compiled_scan`` and ``c2dfb_round``."""
    pt = ptopo.ring(4)
    counts = {}
    for T in (4, 8):
        PA.reset_trace_counts()
        PA.run_async_compiled(bundle.problem, pt, P.C2DFBConfig(**CFG), bundle.x0, bundle.y0, T,
                              fabric=_fabric(pt), policy="bounded", bound=1, device="cpu")
        counts[T] = PA.trace_counts()
    assert counts[4] == counts[8] == {"compiled_scan": 1, "c2dfb_round": 1}
    assert PA.graph_captures() == {}  # no card: no graph


@pytest.mark.parametrize("donate", [True, False])
def test_the_callers_x0_and_y0_are_never_written(bundle, donate):
    pt = ptopo.ring(4)
    before = [v.clone() for v in (bundle.x0, bundle.y0)]
    PA.run_async_compiled(bundle.problem, pt, P.C2DFBConfig(**CFG), bundle.x0, bundle.y0, 3, fabric=_fabric(pt),
                          policy="bounded", bound=1, donate=donate, device="cpu")
    peng.run_baseline_async("mdbo", bundle.problem, pt, PB.MDBOConfig(K=2, neumann_N=1), bundle.x0, bundle.y0, 2,
                            _fabric(pt), compiled=True, device="cpu")
    for a, b in zip(before, (bundle.x0, bundle.y0)):
        assert torch.equal(a, b)


def test_runs_through_one_cache_do_not_share_their_results(bundle):
    """Two runs through one ``fn_cache`` with different x0: distinct final
    states and metrics, and the first run's are unchanged by the second."""
    pt = ptopo.ring(4)
    cache: dict = {}
    kw = dict(fabric=_fabric(pt), policy="bounded", bound=1, fn_cache=cache, device="cpu")
    s1, m1 = PA.run_async_compiled(bundle.problem, pt, P.C2DFBConfig(**CFG), bundle.x0, bundle.y0, 3, **kw)
    kept = [v.clone() for v in pcomp._tensors(s1)] + [m1["hypergrad_norm"].clone()]
    kw["fabric"] = _fabric(pt)
    s2, m2 = PA.run_async_compiled(bundle.problem, pt, P.C2DFBConfig(**CFG), 0.5 * bundle.x0, bundle.y0, 3, **kw)
    assert len(cache) == 1
    assert not torch.equal(s1.x, s2.x) and not torch.equal(m1["hypergrad_norm"], m2["hypergrad_norm"])
    for a, b in zip(kept, pcomp._tensors(s1) + [m1["hypergrad_norm"]]):
        assert torch.equal(a, b)


def test_eager_compiled_and_sim_transport_records_are_equal(bundle):
    """The same run through the eager engine (analytic sizes), the compiled
    runtime and the compiled runtime with a `SimTransport` as its fabric:
    round and node records equal field for field on every parity field."""
    pt = ptopo.ring(4)
    cfg = P.C2DFBConfig(**CFG)
    kw = dict(policy="bounded", bound=1, device="cpu")
    sinks = {k: pobs.MemorySink() for k in ("eager", "compiled", "transport")}
    peng.run_async(bundle.problem, pt, cfg, bundle.x0, bundle.y0, 4, fabric=_fabric(pt), payload_bytes="analytic",
                   obs=pobs.Obs(sink=sinks["eager"], run="eager"), **kw)
    PA.run_async_compiled(bundle.problem, pt, cfg, bundle.x0, bundle.y0, 4, fabric=_fabric(pt),
                          obs=pobs.Obs(sink=sinks["compiled"], run="compiled"), **kw)
    PA.run_async_compiled(bundle.problem, pt, cfg, bundle.x0, bundle.y0, 4, fabric=SimTransport(_fabric(pt)),
                          obs=sinks["transport"], **kw)
    for kind in ("round", "node"):
        rows = {k: pobs.parity_rows(s.records, kind=kind) for k, s in sinks.items()}
        assert len(rows["eager"]) == (4 if kind == "round" else 16)
        assert rows["eager"] == rows["compiled"] == rows["transport"], kind
    raw = sinks["compiled"].rows(kind="round")[0]
    assert set(raw["bytes_by_stream"]) == {"outer", "y", "z"}
    assert raw["wire_bytes"] == sum(raw["bytes_by_stream"].values())
    assert [r["label"] for r in sinks["compiled"].rows(kind="timing")] == ["replay", "cost_analysis", "compile+scan"]


def test_heartbeats_between_rounds_change_nothing(bundle):
    """``Obs(heartbeat_every=2)``: heartbeats at rounds 0, 2 and 4 that
    agree with the round records, no rebuild, and the trajectory of the run
    without them, bit for bit."""
    pt = ptopo.ring(4)
    cfg = P.C2DFBConfig(**CFG)
    kw = dict(policy="bounded", bound=1, device="cpu")
    st_ref, m_ref = PA.run_async_compiled(bundle.problem, pt, cfg, bundle.x0, bundle.y0, 6, fabric=_fabric(pt), **kw)
    sink = pobs.MemorySink()
    PA.reset_trace_counts()
    st_hb, m_hb = PA.run_async_compiled(bundle.problem, pt, cfg, bundle.x0, bundle.y0, 6, fabric=_fabric(pt),
                                        obs=pobs.Obs(sink=sink, heartbeat_every=2, run="hb"), **kw)
    assert PA.trace_counts() == {"compiled_scan": 1, "c2dfb_round": 1}
    _assert_bit_equal(st_ref, m_ref, st_hb, m_hb)
    beats = sink.rows(kind="heartbeat")
    assert [b["round"] for b in beats] == [0, 2, 4]
    rounds = {r["round"]: r for r in sink.rows(kind="round")}
    for b in beats:
        for f in ("hypergrad_norm", "x_consensus_err"):
            assert b[f] == rounds[b["round"]][f]


def test_heartbeat_handles_do_not_share_a_cached_body(bundle):
    pt = ptopo.ring(4)
    cache: dict = {}
    sinks = pobs.MemorySink(), pobs.MemorySink()
    for s in sinks:
        PA.run_async_compiled(bundle.problem, pt, P.C2DFBConfig(**CFG), bundle.x0, bundle.y0, 4, fabric=_fabric(pt),
                              policy="bounded", bound=1, fn_cache=cache, obs=pobs.Obs(sink=s, heartbeat_every=1),
                              device="cpu")
    assert len(cache) == 2
    assert [len(s.rows(kind="heartbeat")) for s in sinks] == [4, 4]


def test_sixteen_freed_heartbeat_handles_build_sixteen_bodies(bundle):
    """Handles built in turn as call arguments are freed after their run,
    so a key by address can meet a dead handle's entry; a key by the
    handle's serial number never does (ROADMAP §C, C8)."""
    pt = ptopo.ring(4)
    cache: dict = {}
    sinks = [pobs.MemorySink() for _ in range(16)]
    for s in sinks:
        PA.run_async_compiled(bundle.problem, pt, P.C2DFBConfig(**CFG), bundle.x0, bundle.y0, 2, fabric=_fabric(pt),
                              policy="bounded", bound=1, fn_cache=cache, obs=pobs.Obs(sink=s, heartbeat_every=1),
                              device="cpu")
    assert len(cache) == 16
    assert [[b["round"] for b in s.rows(kind="heartbeat")] for s in sinks] == [[0, 1]] * 16


def test_a_host_draw_source_is_refused_on_a_card():
    """On a card the draws run inside captured graphs, which replay a
    ``torch.Generator`` on the card only (checked before any work)."""
    cuda = torch.device("cuda")
    pcomp._check_source(None, cuda)
    pcomp._check_source(JaxReplay([], m=4), torch.device("cpu"))
    for src in (JaxReplay([], m=4), torch.Generator()):
        with pytest.raises(ValueError, match="torch.Generator on the card"):
            pcomp._check_source(src, cuda)


def test_write_back_reads_every_output_before_it_is_overwritten():
    """An output carry leaf may be another slot's static buffer: it is read
    before any slot is written."""
    a, b = torch.tensor([1.0]), torch.tensor([2.0])
    new = torch.tensor([3.0])
    pcomp._write_back([a, b], [b, new])  # slot 0 takes slot 1's old value
    assert (float(a), float(b)) == (2.0, 3.0)
    pcomp._write_back([a, b], [a, b])  # unchanged slots are left alone
    assert (float(a), float(b)) == (2.0, 3.0)


# ---------------------------------------------------------------- against the reference's compiled runs


_GATE_REF: dict = {}


@pytest.fixture(scope="module")
def gate_bundles():
    return _bundles(GATE_TASK)


def _reference_gate_run(jb, label):
    """The reference's compiled run of a gate row with obs (shared by the
    row's tests)."""
    if label not in _GATE_REF:
        policy, bound, rule = GATE_ROWS[label]
        sink = jobs.MemorySink()
        js, jm = j_compiled(jb.problem, GATE_JT, J.C2DFBConfig(**GATE_CFG), jb.x0, jb.y0, GATE_T,
                            jax.random.PRNGKey(0), jfab.make_fabric(GATE_JT, **GEO), policy=policy, bound=bound,
                            version_rule=rule, obs=jobs.Obs(sink=sink))
        _GATE_REF[label] = js, jm, sink
    return _GATE_REF[label]


#: the record fields the scheduler and the cost meter decide: equal on every round
SCHEDULED = ("wire_bytes", "sim_seconds", "staleness_max", "staleness_mean", "staleness_hist", "bytes_by_stream",
             "oracle_calls", "compute_flops", "hbm_bytes")
NODE_SCHEDULED = ("wire_bytes", "staleness_max", "staleness_mean", "bytes_by_stream", "compute_flops")


@pytest.mark.parametrize("label", sorted(GATE_ROWS))
def test_gate_rows_equal_the_reference_compiled_run(gate_bundles, label, monkeypatch):
    """The reference's async gate config (m = 6, K = 4, T = 12, geo with
    lognormal stragglers, top-k at 0.5), compiled on both sides.  Every
    scheduler-derived integer and float is equal on every round: ages,
    loop seconds, wire bytes (the gate's totals), simulated seconds,
    staleness rows, histograms, bytes by stream, the records' compute
    counts.  The trajectory agrees within the golden tolerance, with equal
    measured bytes, up to the first round whose top-k margin is a near-tie
    (ROADMAP §C), and builds are the reference's."""
    jb, pb = gate_bundles
    js, jm, jsink = _reference_gate_run(jb, label)
    policy, bound, rule = GATE_ROWS[label]
    pt = ptopo.ring(6)
    steps = _per_step(monkeypatch, _record_topk_margins(monkeypatch))
    sink = pobs.MemorySink()
    PA.reset_trace_counts()
    ps, pm = PA.run_async_compiled(pb.problem, pt, P.C2DFBConfig(**GATE_CFG), pb.x0, pb.y0, GATE_T,
                                   fabric=pfab.make_fabric(pt, **GEO), policy=policy, bound=bound, version_rule=rule,
                                   obs=pobs.Obs(sink=sink), device="cpu")
    assert PA.trace_counts() == {"compiled_scan": 1, "c2dfb_round": 1}
    assert int(np.sum(pm["wire_bytes"])) == int(np.sum(jm["wire_bytes"])) == GATE_WIRE["analytic"][label]
    per_round = 2 * GATE_CFG["K"]
    assert len(steps) == GATE_T * per_round
    tie = next((t for t in range(GATE_T) if min(steps[t * per_round:(t + 1) * per_round]) < TIE), GATE_T)
    assert tie >= 2
    _same_ledger(pm["ledger"], jm["ledger"], None, tie)
    _same_schedule_metrics(pm, jm)
    _round_metrics_close(pm, jm, tie)
    for kind, fields in (("round", SCHEDULED), ("node", NODE_SCHEDULED)):
        prows, jrows = pobs.parity_rows(sink.records, kind=kind), jobs.parity_rows(jsink.records, kind=kind)
        assert len(prows) == len(jrows) == GATE_T * (1 if kind == "round" else 6)
        for p, j in zip(prows, jrows):
            assert {f: p[f] for f in fields} == {f: j[f] for f in fields}, (kind, p["round"])
            if p["round"] < tie:
                _assert_rows_match(p, j, f"{label} {kind} {p['round']}")
    if tie == GATE_T:
        _close(ps.x, js.x, "x")
        _close(ps.inner_y.d_hat, js.inner_y.d_hat, "y refs")
