"""The port's network fabric, time-varying topologies and Erdős–Rényi
topology against the JAX reference, and C2DFB / MDBO / MADSBO priced by a
fabric against LIVE reference runs (never tests/golden/*.npz).

The fabric and the schedules are host numpy on both sides, seeded alike,
so simulated seconds, phase seconds, straggler multipliers, wire bytes,
mixing matrices and edge sets are EQUAL, not close.  Trajectories agree
within the golden tolerance (rtol 1e-4, atol 1e-6)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.net as jnet
from repro.core import baselines as JB
from repro.core import c2dfb as J
from repro.core import topology as jtopo
from repro.data import bilevel_tasks as jtasks
from repro.net import dynamic as jdyn
from repro.net import fabric as jfab
from repro.net import trace as jtrace
import repro_torch.net as pnet
from repro_torch.core import baselines as PB
from repro_torch.core import c2dfb as P
from repro_torch.core import topology as ptopo
from repro_torch.core import types as ptypes
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.data import bilevel_tasks as ptasks
from repro_torch.net import dynamic as pdyn
from repro_torch.net import fabric as pfab
from repro_torch.net import trace as ptrace

from _torch_replay import JaxReplay, record_quant_margins, run_leaf_keys, wire_leaf_keys

RTOL, ATOL = 1e-4, 1e-6
M, TASK = 6, dict(m=6, n=200, p=30, c=3, h=0.5, seed=0)  # tests/test_net_fabric.py's sizes
K, T = 2, 3
PROFILES = ("lan", "wan", "geo", "zero")
STRAGGLERS = {
    "none": {},
    "lognormal": dict(sigma=0.6),
    "bernoulli": dict(p=0.4, slowdown=3.0),
}


def _topologies():
    """(name, reference topology, port topology): a ring, the 2-hop graph
    and an Erdős–Rényi graph (non-ring: degrees differ node to node)."""
    return [
        ("ring6", jtopo.ring(6), ptopo.ring(6)),
        ("two_hop10", jtopo.two_hop(10), ptopo.two_hop(10)),
        ("er10", jtopo.erdos_renyi(10, 0.4, 0), ptopo.erdos_renyi(10, 0.4, 0)),
    ]


# ---------------------------------------------------------------- topology


ER_EDGES = [
    (0, 1), (0, 5), (0, 6), (1, 2), (1, 4), (1, 6), (1, 7), (2, 6), (2, 7),
    (2, 8), (2, 9), (3, 7), (4, 8), (5, 9), (6, 8), (6, 9), (7, 9), (8, 9),
]


@pytest.mark.parametrize("m,p,seed", [(10, 0.4, 0), (6, 0.5, 3), (12, 0.3, 7), (20, 0.2, 11), (8, 1.0, 1), (5, 0.9, 2)])
def test_erdos_renyi_draws_the_reference_graph(m, p, seed):
    want = jtopo.erdos_renyi(m, p, seed)
    got = ptopo.make_topology("er", m, p=p, seed=seed)
    assert got.name == want.name == f"er{p}"
    assert got.neighbors == want.neighbors
    np.testing.assert_array_equal(got.W, want.W)


def test_erdos_renyi_m10_p04_seed0_edges():
    topo = ptopo.make_topology("er", 10, p=0.4, seed=0)
    assert pdyn.base_edges(topo) == ER_EDGES


def test_gnp_edges_at_the_ends_of_p():
    assert ptopo.gnp_edges(4, 1.0, 0) == [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    assert ptopo.gnp_edges(4, 0.0, 0) == []


@pytest.mark.parametrize("name,jt,pt", _topologies(), ids=lambda v: v if isinstance(v, str) else "")
def test_base_edges_follow_networkx_edge_order(name, jt, pt):
    """The random schedules' draws follow the edge order: the port's
    ascending (i, j), i < j, list is the reference's G.edges()."""
    assert pdyn.base_edges(pt) == list(jdyn._graph_of(jt).edges())


# ---------------------------------------------------------------- fabric


def _phases(topo, seed):
    """A ragged round: an int phase, a per-edge dict with unequal payloads,
    and a dict over a subset of the edges."""
    rng = np.random.default_rng(seed)
    edges = jfab.edge_list(topo)
    full = {e: int(b) for e, b in zip(edges, rng.integers(100, 50_000, len(edges)))}
    part = {e: b for k, (e, b) in enumerate(full.items()) if k % 3}
    return [12_345, full, part, 777]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("straggler", sorted(STRAGGLERS))
def test_fabric_equals_the_reference(profile, straggler):
    jt, pt = jtopo.two_hop(10), ptopo.two_hop(10)
    kw = dict(profile=profile, straggler=straggler, compute_s=0.03, seed=5, **STRAGGLERS[straggler])
    jf = jfab.make_fabric(jt, trace=jtrace.NetTrace(), **kw)
    pf = pfab.make_fabric(pt, trace=ptrace.NetTrace(), **kw)
    phases = _phases(jt, 1)
    for t in (0, 1, 4, 2):
        labels = [f"ph{i}" for i in range(len(phases))] if t % 2 else None
        a = jf.simulate_round(phases, t, labels=labels)
        b = pf.simulate_round(phases, t, labels=labels)
        assert b["sim_seconds"] == a["sim_seconds"]
        assert b["wire_bytes"] == a["wire_bytes"]
        assert b["phase_seconds"] == a["phase_seconds"]
        np.testing.assert_array_equal(b["straggler_mult"], a["straggler_mult"])
    assert pf.clock_s == jf.clock_s
    assert pf.trace.to_json() == jf.trace.to_json()
    assert pf.trace.to_chrome_trace() == jf.trace.to_chrome_trace()
    # the per-message (non-barrier) queries
    ra, rb = jf.round_rng(3, stream=7), pf.round_rng(3, stream=7)
    assert [pf.message_arrival(0.5, 4096, rb) for _ in range(5)] == [jf.message_arrival(0.5, 4096, ra) for _ in range(5)]
    assert pf.egress_s(10_000) == jf.egress_s(10_000)
    pf.reset()
    assert pf.clock_s == 0.0


def test_trace_exports_and_step_events_equal(tmp_path):
    jt, pt = jtrace.NetTrace(), ptrace.NetTrace()
    for tr, mod in ((jt, jtrace), (pt, ptrace)):
        tr.add_transfer(mod.TransferEvent(round=0, phase=1, src=2, dst=3, bytes=99, t_start=0.1, t_end=0.25))
        tr.add_phase(mod.PhaseEvent(round=0, phase=1, label="out/x", t_start=0.0, t_end=0.3))
        tr.add_step(mod.StepEvent(round=1, loop="y", step=2, node=4, t_start=0.3, t_end=0.4))
    assert pt.to_json() == jt.to_json()
    assert pt.to_chrome_trace() == jt.to_chrome_trace()
    jt.save(str(tmp_path / "j.json"), chrome=True)
    pt.save(str(tmp_path / "p.json"), chrome=True)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()


def test_edge_helpers_equal():
    jt, pt = jtopo.erdos_renyi(10, 0.4, 0), ptopo.erdos_renyi(10, 0.4, 0)
    assert pfab.edge_list(pt) == jfab.edge_list(jt)
    W = pdyn.LinkDropoutSchedule(pt, p_drop=0.4, seed=3).weights(1)
    assert pfab.edges_from_weights(W) == jfab.edges_from_weights(W)
    phases = _phases(jt, 2)
    act = pfab.edges_from_weights(W)
    assert pfab.mask_phases(phases, act) == jfab.mask_phases(phases, act)


def test_net_exports_the_reference_names():
    assert sorted(pnet.__all__) == sorted(jnet.__all__)
    for name in pnet.__all__:
        assert hasattr(pnet, name)


# ---------------------------------------------------------------- schedules


def _schedules(jt, pt):
    """(reference schedule, port schedule) pairs of every kind."""
    jf = jfab.make_fabric(jt, profile="wan", seed=3)
    pf = pfab.make_fabric(pt, profile="wan", seed=3)
    return {
        "static": (jdyn.StaticSchedule(jt), pdyn.StaticSchedule(pt)),
        "dropout": (jdyn.LinkDropoutSchedule(jt, p_drop=0.3, seed=1), pdyn.LinkDropoutSchedule(pt, p_drop=0.3, seed=1)),
        "random_edges": (jdyn.RandomEdgeSchedule(jt, n_edges=4, seed=2), pdyn.RandomEdgeSchedule(pt, n_edges=4, seed=2)),
        # a deadline inside the jitter band: some edges miss it, some make it
        "latency": (
            jdyn.LatencyDropoutSchedule(jt, fabric=jf, deadline_s=0.0313, payload_bytes=4096),
            pdyn.LatencyDropoutSchedule(pt, fabric=pf, deadline_s=0.0313, payload_bytes=4096),
        ),
        "b_connected": (jdyn.BConnectedSchedule(jt, B=3), pdyn.BConnectedSchedule(pt, B=3)),
    }


@pytest.mark.parametrize("name,jt,pt", _topologies(), ids=lambda v: v if isinstance(v, str) else "")
def test_every_schedule_equals_the_reference(name, jt, pt):
    for kind, (js, ps) in _schedules(jt, pt).items():
        for t in range(8):
            np.testing.assert_array_equal(ps.weights(t), js.weights(t), err_msg=f"{kind} t={t}")
            assert ps.active_edges(t) == js.active_edges(t), (kind, t)
        np.testing.assert_array_equal(ps.stack(8), js.stack(8))
        for t0, window in ((0, 1), (0, 3), (2, 4), (1, 8)):
            assert pdyn.is_jointly_connected(ps, t0, window) == jdyn.is_jointly_connected(js, t0, window), (kind, t0)
        masks = pdyn.active_edge_masks(ps.stack(8))
        np.testing.assert_array_equal(masks, jdyn.active_edge_masks(js.stack(8)))
        for vpr in (1, 3):
            lags, worst = pdyn.schedule_version_lags(masks, vpr)
            jlags, jworst = jdyn.schedule_version_lags(masks, vpr)
            np.testing.assert_array_equal(lags, jlags)
            assert worst == jworst


def test_schedules_drop_some_edges():
    """The schedules above are not all trivial: on the ER graph the dropout,
    random-edge and latency schedules each drop edges in some round."""
    jt, pt = jtopo.erdos_renyi(10, 0.4, 0), ptopo.erdos_renyi(10, 0.4, 0)
    full = len(pfab.edge_list(pt))
    for kind in ("dropout", "random_edges", "latency"):
        ps = _schedules(jt, pt)[kind][1]
        sizes = {len(ps.active_edges(t)) for t in range(8)}
        assert min(sizes) < full, kind


def _bad_stacks(topo):
    m = topo.m
    W = np.stack([topo.W] * 3)
    asym = W.copy()
    asym[1, 0, 1] += 0.1
    rows = W * 1.01
    neg = W.copy()
    neg[2, 0, 0] = -0.5
    neg[2, 0, 1] += 0.75
    neg[2, 1, 0] += 0.75
    neg[2, 1, 1] -= 0.75
    phantom = W.copy()
    i, j = next((i, j) for i in range(m) for j in range(m) if i != j and j not in topo.neighbors[i])
    for a, b in ((i, j), (j, i)):
        phantom[0, a, b] = 0.1
    for a in (i, j):
        phantom[0, a, a] -= 0.1
    return {"shape": W[:, :, :-1], "asym": asym, "rows": rows, "neg": neg, "phantom": phantom, "ok": W}


def test_validate_schedule_stack_raises_the_reference_errors():
    jt, pt = jtopo.ring(6), ptopo.ring(6)
    for what, Ws in _bad_stacks(jt).items():
        for base in (None, "topo"):
            def outcome(mod, topo):
                try:
                    out = mod.validate_schedule_stack(Ws, 3, 6, base=topo if base else None)
                except ValueError as e:
                    return "raise", str(e)
                return "ok", out.tolist()
            assert outcome(pdyn, pt) == outcome(jdyn, jt), (what, base)
    assert outcome(pdyn, pt)[0] == "ok"
    with pytest.raises(ValueError, match="not in the base topology"):
        pdyn.validate_schedule_stack(_bad_stacks(pt)["phantom"], 3, 6, base=pt)


def test_latency_schedule_needs_a_fabric():
    with pytest.raises(ValueError, match="needs the NetworkFabric"):
        pdyn.LatencyDropoutSchedule(ptopo.ring(4))


# ---------------------------------------------------------------- algorithms


@pytest.fixture(scope="module")
def bundles():
    """The reference's bundle and the port's, the port's x0 and y0 replaced
    by the reference's (torch cannot draw the reference's y0)."""
    jb = jtasks.coefficient_tuning_task(**TASK)
    pb = ptasks.coefficient_tuning_task(**TASK, device="cpu")
    return jb, dataclasses.replace(pb, x0=from_numpy(jb.x0), y0=from_numpy(jb.y0))


def _assert_tree_close(got, want, what):
    g = ptypes.tree_leaves(to_numpy(got))
    w = jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_states_close(ps, js):
    for what in ("x", "s_x"):
        _assert_tree_close(getattr(ps, what), getattr(js, what), what)
    _assert_tree_close(ps.inner_y.d, js.inner_y.d, "y")
    _assert_tree_close(ps.inner_z.d, js.inner_z.d, "z")


def _fabric_pair(topo_name="ring", straggler="lognormal"):
    jt = jtopo.make_topology(topo_name, M)
    pt = ptopo.make_topology(topo_name, M)
    kw = dict(profile="wan", straggler=straggler, compute_s=0.02, seed=0)
    return jt, pt, jfab.make_fabric(jt, **kw), pfab.make_fabric(pt, **kw)


@pytest.mark.parametrize("override", [False, True], ids=["topology_W", "schedule_W"])
def test_c2dfb_round_with_fabric_matches_reference(bundles, override):
    jb, pb = bundles
    jt, pt, jf, pf = _fabric_pair()
    cfg_kw = dict(K=K, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    jcfg, pcfg = J.C2DFBConfig(**cfg_kw), P.C2DFBConfig(**cfg_kw)
    js = J.init_state(jb.problem, jcfg, jb.x0, jb.y0)
    ps = P.init_state(pb.problem, pcfg, pb.x0, pb.y0)
    W = pdyn.LinkDropoutSchedule(pt, p_drop=0.4, seed=2).weights(1) if override else None
    key = jax.random.PRNGKey(0)
    for r in range(2):
        js, jm = J.c2dfb_round(js, key, jb.problem, jt, jcfg, W=W, fabric=jf, round_idx=r)
        ps, pm = P.c2dfb_round(
            ps, None, pb.problem, pt, pcfg,
            W=None if W is None else torch.as_tensor(W, dtype=torch.float32), fabric=pf, round_idx=r,
        )
        assert pm["wire_bytes"] == jm["wire_bytes"] and isinstance(pm["wire_bytes"], int)
        assert pm["sim_seconds"] == jm["sim_seconds"]
        assert int(pm["measured_bytes"]) == int(jm["measured_bytes"])
    _assert_states_close(ps, js)
    if override:  # the dropped edges are not priced
        _, _, _, full = _fabric_pair()
        _, fm = P.c2dfb_round(ps, None, pb.problem, pt, pcfg, fabric=full, round_idx=1)
        assert pm["wire_bytes"] < fm["wire_bytes"]


RUN_CASES = {
    # deterministic compressor, a dropout schedule on a ring
    "kernel_topk_dropout": ("ring", dict(compressor="kernel_topk", comp_ratio=0.2, comp_block=128),
                            lambda t: (jdyn.LinkDropoutSchedule(t[0], p_drop=0.3, seed=4),
                                       pdyn.LinkDropoutSchedule(t[1], p_drop=0.3, seed=4))),
    # exact top-k, no schedule, on the ER graph
    "topk_er": ("er", dict(compressor="topk", comp_ratio=0.3), None),
    # the stochastic quantizer on the reference's replayed draws, B-connected
    "kernel_quant_bconnected": ("ring", dict(compressor="kernel_quant", comp_bits=4, comp_block=128),
                                lambda t: (jdyn.BConnectedSchedule(t[0], B=2), pdyn.BConnectedSchedule(t[1], B=2))),
}
# of keys 0-19, the one whose smallest distance between a sample and its
# rounding threshold is largest in the kernel_quant run, 8.9e-5
# (quantization is discontinuous; see tests/test_torch_c2dfb.py)
RUN_KEYS = {"kernel_quant_bconnected": 12}


@pytest.fixture(scope="module", params=sorted(RUN_CASES))
def fabric_run(request, bundles):
    jb, pb = bundles
    topo_name, cfg_kw, make_sched = RUN_CASES[request.param]
    jt, pt, jf, pf = _fabric_pair(topo_name)
    js_, ps_ = make_sched((jt, pt)) if make_sched else (None, None)
    jcfg, pcfg = J.C2DFBConfig(K=K, **cfg_kw), P.C2DFBConfig(K=K, **cfg_kw)
    key = jax.random.PRNGKey(RUN_KEYS.get(request.param, 0))
    js, jm = J.run(jb.problem, jt, jcfg, jb.x0, jb.y0, T=T, key=key, schedule=js_, fabric=jf)
    n_leaves = len(ptypes.tree_leaves(pb.y0))
    # the rounds' draws, then round_phases' (fold_in(key, 0x5EED) in the reference)
    keys = list(run_leaf_keys(key, T, K, n_leaves)) + list(wire_leaf_keys(jax.random.fold_in(key, 0x5EED), n_leaves))
    replay = JaxReplay(keys, M)
    with pytest.MonkeyPatch.context() as mp:
        margins = record_quant_margins(mp)
        ps, pm = P.run(
            pb.problem, pt, pcfg, pb.x0, pb.y0, T=T,
            generator=replay, device="cpu", schedule=ps_, fabric=pf,
        )
    return dict(name=request.param, js=js, jm=jm, ps=ps, pm=pm, replay=replay, pcfg=pcfg, pt=pt, ps_=ps_,
                margins=margins)


def test_run_with_fabric_and_schedule_matches_reference(fabric_run):
    r = fabric_run
    _assert_states_close(r["ps"], r["js"])
    jm, pm = r["jm"], r["pm"]
    assert set(pm) == set(jm)
    for k in ("sim_seconds", "wire_bytes"):
        assert isinstance(pm[k], np.ndarray) and pm[k].shape == (T,)
        assert pm[k].dtype == np.asarray(jm[k]).dtype
        np.testing.assert_array_equal(pm[k], np.asarray(jm[k]), err_msg=k)
    np.testing.assert_array_equal(pm["measured_bytes"].numpy(), np.asarray(jm["measured_bytes"]))
    for k in ("hypergrad_norm", "x_consensus_err", "y_consensus_err", "z_consensus_err"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    if r["name"].startswith("kernel_quant"):
        # every replayed key was drawn: T rounds of 4K messages, then 4 for the phases
        assert r["replay"].draws == T * 4 * K + 4
        # no sample lies within 1e-5 of its rounding threshold
        assert len(r["margins"]) == T * 4 * K + 4 and min(r["margins"]) > 1e-5


def test_wire_bytes_closed_form(fabric_run):
    """What chip_smoke.py checks at full width: a round's wire bytes are
    the dense broadcasts, 2 x (active directed edges) x dx x 4, plus K
    times each active edge's sender's four inner messages, measured on the
    final state; without a schedule, on a ring (two out-edges a node), that
    is twice round_wire_bytes_measured's inner bytes plus twice the raw
    f32 x and s_x broadcasts (the dense codec's total adds a header a
    message, which the fabric's dense phases do not carry)."""
    r = fabric_run
    ps, pcfg, pt = r["ps"], r["pcfg"], r["pt"]
    dx = ptypes.tree_count(ps.x)
    per_node = np.zeros(M, dtype=np.int64)
    gen = torch.Generator().manual_seed(0)  # quant messages have a fixed size
    for inner in (ps.inner_y, ps.inner_z):
        bd, bs = P.inner_message_bytes(inner, pcfg.make_compressor(), gen)
        per_node += np.asarray(bd) + np.asarray(bs)
    for t in range(T):
        act = r["ps_"].active_edges(t) if r["ps_"] is not None else pfab.edge_list(pt)
        want = 2 * len(act) * dx * 4 + pcfg.K * sum(int(per_node[i]) for i, _ in act)
        assert int(r["pm"]["wire_bytes"][t]) == want


def test_ring_without_schedule_is_twice_the_measured_round(bundles):
    jb, pb = bundles
    _, pt, _, pf = _fabric_pair("ring", "none")
    pcfg = P.C2DFBConfig(K=K, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    ps, pm = P.run(pb.problem, pt, pcfg, pb.x0, pb.y0, T=2, device="cpu", fabric=pf)
    inner = P.round_wire_bytes_measured(ps, pcfg, pt)["inner_bytes"]
    outer = 2 * ptypes.tree_count(ps.x) * 4 * M
    np.testing.assert_array_equal(pm["wire_bytes"], [2 * (inner + outer)] * 2)


@pytest.mark.parametrize("compressor", ["quant", "kernel_quant"])
def test_quant_codec_bytes_do_not_depend_on_the_draws(bundles, compressor):
    """A quant or kernel_quant message has a fixed size, so under a plain
    torch.Generator (not the reference's draws) the wire bytes, simulated
    seconds and metered bytes still equal the reference's.

    randk is left out on purpose: its message carries the drawn
    coordinates whose residual is nonzero, and on this task some residuals
    cancel to exactly 0.0 in one package and to an ulp in the other (seen
    on the CPU: s - s_hat of -1.19e-7 against 0.0), so its bytes differ by
    a few records even on the reference's own draws."""
    jb, pb = bundles
    jt, pt, jf, pf = _fabric_pair()
    cfg_kw = dict(K=K, compressor=compressor, comp_bits=4, comp_block=128)
    _, jm = J.run(jb.problem, jt, J.C2DFBConfig(**cfg_kw), jb.x0, jb.y0, T=2, key=jax.random.PRNGKey(0), fabric=jf)
    gen = torch.Generator().manual_seed(1)
    _, pm = P.run(pb.problem, pt, P.C2DFBConfig(**cfg_kw), pb.x0, pb.y0, T=2, generator=gen, device="cpu", fabric=pf)
    np.testing.assert_array_equal(pm["wire_bytes"], np.asarray(jm["wire_bytes"]))
    np.testing.assert_array_equal(pm["sim_seconds"], np.asarray(jm["sim_seconds"]))
    np.testing.assert_array_equal(pm["measured_bytes"].numpy(), np.asarray(jm["measured_bytes"]))


def test_run_rejects_the_slices_still_to_port(bundles):
    _, pb = bundles
    cfg = P.C2DFBConfig(K=1)
    for kw, what in ((dict(async_mode="bounded"), "asynchronous"), (dict(mixing_damping="inverse-age"), "asynchronous"),
                     (dict(transport=object()), "transport")):
        with pytest.raises(ValueError, match=what):
            P.run(pb.problem, ptopo.ring(M), cfg, pb.x0, pb.y0, T=1, device="cpu", **kw)


def test_run_with_a_phantom_edge_schedule_needs_no_fabric(bundles):
    """The base-edge check binds only when a fabric prices the run."""
    _, pb = bundles
    pt = ptopo.ring(M)
    sched = pdyn.StaticSchedule(ptopo.complete(M))
    P.run(pb.problem, pt, P.C2DFBConfig(K=1), pb.x0, pb.y0, T=1, device="cpu", schedule=sched)
    with pytest.raises(ValueError, match="not in the base topology"):
        P.run(pb.problem, pt, P.C2DFBConfig(K=1), pb.x0, pb.y0, T=1, device="cpu", schedule=sched,
              fabric=pfab.make_fabric(pt))


@pytest.mark.parametrize("alg", ["mdbo", "madsbo"])
@pytest.mark.parametrize("override", [False, True], ids=["topology_W", "schedule_W"])
def test_baselines_with_fabric_match_reference(bundles, alg, override):
    jb, pb = bundles
    jt, pt, jf, pf = _fabric_pair()
    W = pdyn.LinkDropoutSchedule(pt, p_drop=0.4, seed=2).weights(0) if override else None
    Wt = None if W is None else torch.as_tensor(W, dtype=torch.float32)
    if alg == "mdbo":
        jcfg, pcfg = JB.MDBOConfig(K=2, neumann_N=2), PB.MDBOConfig(K=2, neumann_N=2)
        js, ps = JB.mdbo_init(jb.x0, jb.y0), PB.mdbo_init(pb.x0, pb.y0)
        jstep = lambda s, r: JB.mdbo_round(s, jb.problem, jt, jcfg, W=W, fabric=jf, round_idx=r)  # noqa: E731
        pstep = lambda s, r: PB.mdbo_round(s, pb.problem, pt, pcfg, W=Wt, fabric=pf, round_idx=r)  # noqa: E731
        extra = pcfg.neumann_N
    else:
        jcfg, pcfg = JB.MADSBOConfig(K=2, Q=3), PB.MADSBOConfig(K=2, Q=3)
        js, ps = JB.madsbo_init(jb.problem, jb.x0, jb.y0), PB.madsbo_init(pb.problem, pb.x0, pb.y0)
        jstep = lambda s, r: JB.madsbo_round(s, jb.problem, jt, jcfg, W=W, fabric=jf, round_idx=r)  # noqa: E731
        pstep = lambda s, r: PB.madsbo_round(s, pb.problem, pt, pcfg, W=Wt, fabric=pf, round_idx=r)  # noqa: E731
        extra = pcfg.Q
    for r in range(2):
        js, jm = jstep(js, r)
        ps, pm = pstep(ps, r)
        assert pm["wire_bytes"] == jm["wire_bytes"]
        assert pm["sim_seconds"] == jm["sim_seconds"]
        np.testing.assert_allclose(float(pm["hypergrad_norm"]), float(jm["hypergrad_norm"]), rtol=RTOL, atol=ATOL)
    _assert_tree_close(ps.x, js.x, "x")
    if not override:  # every broadcast crosses both ring links of its sender
        dx, dy = TASK["p"], TASK["p"] * TASK["c"]
        assert pm["wire_bytes"] == (pcfg.K * dy + extra * dy + dx) * 4 * 2 * M


def test_static_schedule_run_is_bit_for_bit_the_plain_run(bundles):
    _, pb = bundles
    pt = ptopo.ring(M)
    cfg = P.C2DFBConfig(K=K, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    s0, m0 = P.run(pb.problem, pt, cfg, pb.x0, pb.y0, T=2, device="cpu")
    s1, m1 = P.run(pb.problem, pt, cfg, pb.x0, pb.y0, T=2, device="cpu", schedule=pdyn.StaticSchedule(pt))
    for a, b in zip([s0.x, s0.s_x, *s0.inner_y, *s0.inner_z], [s1.x, s1.s_x, *s1.inner_y, *s1.inner_z]):
        for la, lb in zip(ptypes.tree_leaves(a), ptypes.tree_leaves(b)):
            assert torch.equal(la, lb)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
