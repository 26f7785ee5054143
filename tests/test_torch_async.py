"""The port's eager asynchronous engine against LIVE runs of the JAX
reference (never tests/golden/*.npz): the delayed mixing and damping, the
event-driven scheduler, the staleness ledger, C2DFB and the MDBO / MADSBO
baselines under staleness, the telemetry records with their compute meter,
and ``inner_loop(fabric=)``.

The scheduler and the ledger are host numpy on both sides, seeded alike, so
timelines, ages, histograms, simulated seconds and bytes are EQUAL.
Trajectories agree within the golden tolerance (rtol 1e-4, atol 1e-6).
Top-k selection is discontinuous, like quantization: where the k-th and
(k+1)-th magnitudes of a residual lie within the two packages' rounding
difference, the two runs may keep different coordinates, and from there on
their trajectories part (and with them the measured sizes of later
payloads, which count exact zeros).  So the gate rows are compared round
by round: every round the port runs on the reference's own input state,
keeping the coordinates the reference kept, and a row where its own
choice differs must be such a near-tie.  Their free runs are compared up
to the first near-tie.  The gate rows (the reference's async regression
gate, T = 12) run in tests/test_torch_async_gate.py and
tests/test_torch_async_gate_sync_full.py, spread over the workers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.async_gossip as JA
from repro.async_gossip import engine as jeng
from repro.core import baselines as JB
from repro.core import c2dfb as J
from repro.core import inner_loop as jinner
from repro.core import topology as jtopo
from repro.data import bilevel_tasks as jtasks
from repro.net import dynamic as jdyn
from repro.net import fabric as jfab
import repro.obs as jobs
import repro_torch.async_gossip as PA
import repro_torch.obs as pobs
from repro_torch.async_gossip import engine as peng
from repro_torch.core import baselines as PB
from repro_torch.core import c2dfb as P
from repro_torch.core import inner_loop as pinner
from repro_torch.core.gossip import mix_delta_dense
from repro_torch.core import topology as ptopo
from repro_torch.core import types as ptypes
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.data import bilevel_tasks as ptasks
from repro_torch.net import dynamic as pdyn
from repro_torch.net import fabric as pfab

from _torch_replay import (
    JaxReplay,
    async_run_leaf_keys,
    inner_loop_fabric_leaf_keys,
    record_quant_margins,
)

RTOL, ATOL = 1e-4, 1e-6
EXACT_FLOATS = ("sim_seconds", "compute_flops", "hbm_bytes", "staleness_mean")
GEO = dict(profile="geo", straggler="lognormal", compute_s=0.05, sigma=0.8, seed=0)


def _close(got, want, what):
    g = ptypes.tree_leaves(to_numpy(got))
    w = jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=what)


def _dist_atol(x) -> float:
    """How finely float32 resolves a node's distance to the node mean,
    ||x_i - x_bar||: each coordinate of x_i - x_bar to about one ulp of
    max|x| (the packages sum the mean in another order), so the norm to
    sqrt(d) of them; twice that.  The baselines' consensus distances
    (~5e-6 at x ~ 4) lie near it, where the golden atol of 1e-6 would
    compare rounding noise."""
    x = np.asarray(x, np.float32)
    return 2.0 * float(np.spacing(np.abs(x).max())) * float(np.sqrt(x[0].size))


def _bundles(task_kw):
    jb = jtasks.coefficient_tuning_task(**task_kw)
    pb = ptasks.coefficient_tuning_task(**task_kw, device="cpu")
    return jb, dataclasses.replace(pb, x0=from_numpy(np.asarray(jb.x0)), y0=from_numpy(np.asarray(jb.y0)))


def _same_ledger(pl, jl, rounds=None, curve=None):
    """Ages and loop seconds of the first ``rounds`` rounds (all by default)
    are equal, and with every round the histogram and age statistics; the
    consensus curve of the first ``curve`` rounds agrees."""
    assert len(pl.loops) == len(jl.loops)
    for p, j in zip(pl.loops, jl.loops):
        assert (p.round, p.loop, p.edges) == (j.round, j.loop, j.edges)
        if rounds is None or p.round < rounds:
            assert np.array_equal(p.ages, j.ages) and (p.t_start, p.t_end) == (j.t_start, j.t_end)
    if rounds is None:
        np.testing.assert_array_equal(pl.histogram(), jl.histogram())
        assert pl.max_age() == jl.max_age() and pl.mean_age() == jl.mean_age()
    pt, pe = pl.curve()
    jt, je = jl.curve()
    np.testing.assert_array_equal(pt[:rounds], jt[:rounds])
    np.testing.assert_allclose(pe[:curve], je[:curve], rtol=RTOL, atol=ATOL)


SCHEDULER_KEYS = ("sim_seconds", "wire_bytes", "staleness_max", "staleness_mean", "staleness_hist")


def _same_schedule_metrics(pm, jm, rounds=None):
    """Scheduler-side metrics (host numpy on both sides) are equal."""
    for k in SCHEDULER_KEYS:
        a, b = np.asarray(pm[k]), np.asarray(jm[k])
        if rounds is not None:
            a, b = a[:rounds], b[:rounds]
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def _round_metrics_close(pm, jm, rounds=None):
    keys = set(jm) - set(SCHEDULER_KEYS) - {"ledger"}
    assert keys == set(pm) - set(SCHEDULER_KEYS) - {"ledger"}
    for k in keys:
        a, b = pm[k].numpy(), np.asarray(jm[k])
        if rounds is not None:
            a, b = a[:rounds], b[:rounds]
        if k == "measured_bytes":
            assert np.array_equal(a, b), k
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)


# ---------------------------------------------------------------- mixing


@pytest.mark.parametrize("policy", ["none", "inverse-age", "exp-decay"])
def test_damping_and_delayed_mixing_equal_the_reference(policy):
    rng = np.random.default_rng(0)
    m, depth, decay = 5, 4, 0.6
    a = rng.integers(0, depth, size=(m, m)).astype(np.int32)
    ages = np.triu(a, 1) + np.triu(a, 1).T
    W = np.asarray(jtopo.ring(m).W, np.float32)
    np.testing.assert_allclose(
        PA.damping_factor(torch.from_numpy(ages), policy, decay).numpy(),
        np.asarray(JA.damping_factor(ages, policy, decay)), rtol=1e-6, atol=0,
    )
    np.testing.assert_allclose(
        PA.damp_weights(torch.from_numpy(W), torch.from_numpy(ages), policy, decay).numpy(),
        np.asarray(JA.damp_weights(jnp.asarray(W), jnp.asarray(ages), policy, decay)), rtol=1e-6, atol=1e-7,
    )
    hist = {"a": rng.normal(size=(depth, m, 3, 2)).astype(np.float32), "b": rng.normal(size=(depth, m, 4)).astype(np.float32)}
    want = JA.mix_delta_delayed(jnp.asarray(W), jax.tree.map(jnp.asarray, hist), jnp.asarray(ages), policy, decay)
    got = PA.mix_delta_delayed(torch.from_numpy(W), from_numpy(hist), torch.from_numpy(ages), policy, decay)
    _close(got, want, f"mix_delta_delayed {policy}")
    # zero ages: the delayed operator is the dense one on the current slot
    zero = PA.mix_delta_delayed(torch.from_numpy(W), from_numpy(hist), torch.zeros((m, m), dtype=torch.int32), policy)
    dense = mix_delta_dense(torch.from_numpy(W), ptypes.tree_map(lambda h: h[0], from_numpy(hist)))
    for za, da in zip(ptypes.tree_leaves(zero), ptypes.tree_leaves(dense)):
        torch.testing.assert_close(za, da, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown mixing_damping"):
        PA.damping_factor(ages, "linear")


def test_depth_rule_ages_and_histories_equal_the_reference():
    for policy in ("sync", "bounded", "full"):
        for bound in (0, 1, 2, 5):
            for K in (0, 1, 4, 10):
                for lag in (0, 3, 12):
                    assert PA.required_depth(policy, bound, K, lag) == JA.required_depth(policy, bound, K, lag)
    rng = np.random.default_rng(1)
    topo = jtopo.ring(6)
    for S in (0, 1, 3):
        lag = rng.integers(0, 9, size=(6, 6))
        lag = np.triu(lag, 1) + np.triu(lag, 1).T
        np.testing.assert_array_equal(
            PA.deterministic_ages(5, S, lag, topo.neighbors), JA.deterministic_ages(5, S, lag, topo.neighbors)
        )
    v = {"a": torch.arange(6.0).reshape(3, 2)}
    h = PA.init_history(v, 3)
    assert h["a"].shape == (3, 3, 2) and all(torch.equal(h["a"][i], v["a"]) for i in range(3))
    h2 = PA.push_history(h, {"a": v["a"] + 10})
    assert torch.equal(h2["a"][0], v["a"] + 10) and torch.equal(h2["a"][1], v["a"]) and torch.equal(h["a"][0], v["a"])


# ---------------------------------------------------------------- scheduler


def _timeline_fields(tl):
    return dict(
        ages=tl.ages, mix_s=tl.mix_s, finish_s=tl.finish_s, end_s=tl.end_s, wire_bytes=tl.wire_bytes,
        node_wire_bytes=tl.node_wire_bytes, ack_wire_bytes=tl.ack_wire_bytes,
        node_ack_wire_bytes=tl.node_ack_wire_bytes,
    )


def _assert_timelines_equal(p, j, what):
    for k, jv in _timeline_fields(j).items():
        pv = _timeline_fields(p)[k]
        assert np.asarray(pv).dtype == np.asarray(jv).dtype, (what, k)
        assert np.array_equal(pv, jv), (what, k)


@pytest.mark.parametrize("masked", [False, True], ids=["static", "dropout"])
@pytest.mark.parametrize("rule", ["common", "deterministic", "acked"])
@pytest.mark.parametrize("policy", ["sync", "bounded", "full"])
def test_scheduler_timelines_equal_the_reference(policy, rule, masked):
    """drive_round over 4 rounds: ages, mix / finish / end seconds, per-node
    and ack bytes and the round's per-stream split are EQUAL; under a
    dropout schedule re-entering edges carry their version lag and pay a
    catch-up."""
    m, K = 6, 3
    jt, pt = jtopo.ring(m), ptopo.ring(m)
    kw = dict(profile="wan", straggler="lognormal", sigma=0.7, compute_s=0.02, seed=3)
    if policy == "full" and rule == "deterministic":
        for sched, fab in ((JA.AsyncScheduler, jfab.make_fabric(jt, **kw)), (PA.AsyncScheduler, pfab.make_fabric(pt, **kw))):
            with pytest.raises(ValueError, match="needs a gated policy"):
                sched(fab, policy=policy, bound=1, version_rule=rule)
        return
    js = JA.AsyncScheduler(jfab.make_fabric(jt, **kw), policy=policy, bound=1, version_rule=rule)
    ps = PA.AsyncScheduler(pfab.make_fabric(pt, **kw), policy=policy, bound=1, version_rule=rule)
    masks = (
        jdyn.active_edge_masks(jdyn.LinkDropoutSchedule(jt, p_drop=0.4, seed=1).stack(4)) if masked else [None] * 4
    )
    bytes_y = np.arange(600, 600 + 7 * m, 7)
    for t in range(4):
        kw_round = dict(active=masks[t], catchup_bytes=5000 if masked else 0, track_lag=masked)
        jr = js.drive_round(t, K, bytes_y, 700, 400, 0.01, **kw_round)
        pr = ps.drive_round(t, K, bytes_y, 700, 400, 0.01, **kw_round)
        _assert_timelines_equal(pr.tl_y, jr.tl_y, f"round {t} y")
        _assert_timelines_equal(pr.tl_z, jr.tl_z, f"round {t} z")
        assert (pr.t_start, pr.x_end, pr.t_end) == (jr.t_start, jr.x_end, jr.t_end)
        assert pr.wire_bytes_by_stream == jr.wire_bytes_by_stream
        assert np.array_equal(pr.node_wire_bytes, jr.node_wire_bytes)
        assert all(pr.node_bytes_by_stream(i) == jr.node_bytes_by_stream(i) for i in range(m))
        assert np.array_equal(ps.version_lag, js.version_lag)
    if masked:
        assert js.version_lag.max() > 0  # the schedule did drop edges
    assert ps.depth_for(K, 5) == js.depth_for(K, 5) and ps.history_depth == js.history_depth


def test_ledger_statistics_equal_the_reference():
    rng = np.random.default_rng(2)
    m, edges = 5, jfab.edge_list(jtopo.ring(5))
    ages = [rng.integers(0, 4, size=(3, m, m)).astype(np.int32) for _ in range(4)]
    got = PA.staleness_stats(PA.edge_age_samples(ages, edges), 4)
    want = JA.staleness_stats(JA.edge_age_samples(ages, edges), 4)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    from repro.async_gossip.ledger import node_staleness_stats as jnode
    from repro_torch.async_gossip.ledger import node_staleness_stats as pnode

    assert all(np.array_equal(a, b) for a, b in zip(pnode(ages, edges, m), jnode(ages, edges, m)))
    pl, jl = PA.StalenessLedger(), JA.StalenessLedger()
    for t, a in enumerate(ages):
        for led in (pl, jl):
            led.record_loop(t, "y", a, t, t + 0.5, edges=edges[: 2 + t])
            led.record_point(t + 1.0, 1.0 / (t + 1))
    _same_ledger(pl, jl)
    assert pl.time_to_error(0.4) == jl.time_to_error(0.4)


# ---------------------------------------------------------------- zero staleness is sync, bit for bit


@pytest.mark.parametrize("policy", ["sync", "bounded", "full"])
def test_zero_latency_async_run_is_the_sync_run_bit_for_bit(policy):
    """On a zero-latency fabric every age is 0, so every round takes the
    synchronous path: state and metrics equal the port's sync ``run``."""
    _, pb = _bundles(dict(m=6, n=200, p=30, c=3, h=0.5, seed=0))
    pt = ptopo.ring(6)
    cfg = P.C2DFBConfig(K=2, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    s0, m0 = P.run(pb.problem, pt, cfg, pb.x0, pb.y0, T=3, device="cpu")
    s1, m1 = P.run(pb.problem, pt, cfg, pb.x0, pb.y0, T=3, device="cpu", async_mode=policy,
                   fabric=pfab.make_fabric(pt, profile="zero", straggler="none", seed=0))
    assert int(m1["staleness_max"].max()) == 0
    trees = lambda s: [s.x, s.s_x, s.u_prev, *s.inner_y, *s.inner_z]  # noqa: E731
    for a, b in zip(trees(s0), trees(s1)):
        for la, lb in zip(ptypes.tree_leaves(a), ptypes.tree_leaves(b)):
            assert torch.equal(la, lb)
    for k, v in m0.items():
        assert torch.equal(v, m1[k]), k


# ---------------------------------------------------------------- top-k margins a step


def _per_step(monkeypatch, margins) -> list:
    """The smallest entry of ``margins`` that each inner step of the rounds
    appended (2 * K a round, y loop then z loop); the metering's
    compressions, whose selection moves no state, are left out."""
    steps = []
    apply = pinner.inner_apply

    def wrapped(state, *args, **kwargs):
        n = len(margins)
        out = apply(state, *args, **kwargs)
        if not ptypes.tree_leaves(state.d)[0].is_meta:  # the cost meter's count of the other branch
            steps.append(min(margins[n:], default=float("inf")))
        return out

    monkeypatch.setattr(pinner, "inner_apply", wrapped)
    return steps


# ---------------------------------------------------------------- schedules, damping, quantizers, baselines


SMALL = dict(m=6, n=200, p=30, c=3, h=0.8, seed=0)
SMALL_CFG = dict(K=2, compressor="topk", comp_ratio=0.5)


@pytest.fixture(scope="module")
def small():
    return _bundles(SMALL)


@pytest.mark.parametrize("damping", ["inverse-age", "exp-decay"])
def test_schedule_composed_damped_run_equals_the_reference(small, damping):
    """Fully async with a link-dropout schedule (edges re-enter with their
    version lag, histories carried across rounds) and damping."""
    jb, pb = small
    jt, pt = jtopo.ring(6), ptopo.ring(6)
    kw = dict(policy="full", mixing_damping=damping, damping_decay=0.6)
    js, jm = jeng.run_async(jb.problem, jt, J.C2DFBConfig(**SMALL_CFG), jb.x0, jb.y0, 4, jax.random.PRNGKey(0),
                            jfab.make_fabric(jt, **GEO), schedule=jdyn.LinkDropoutSchedule(jt, p_drop=0.3, seed=0),
                            **kw)
    ps, pm = peng.run_async(pb.problem, pt, P.C2DFBConfig(**SMALL_CFG), pb.x0, pb.y0, 4,
                            fabric=pfab.make_fabric(pt, **GEO), device="cpu",
                            schedule=pdyn.LinkDropoutSchedule(pt, p_drop=0.3, seed=0), **kw)
    assert int(np.max(jm["staleness_max"])) > 1  # re-entering edges mixed old versions
    _same_ledger(pm["ledger"], jm["ledger"])
    _same_schedule_metrics(pm, jm)
    _round_metrics_close(pm, jm)
    _close(ps.x, js.x, "x")
    _close(ps.inner_z.d_hat, js.inner_z.d_hat, "z refs")


def test_kernel_quant_run_replays_the_reference_draws(small, monkeypatch):
    """kernel_quant under bounded staleness with measured payloads: the
    port draws the reference's own samples, in its key order (each round's
    metering before the round)."""
    jb, pb = small
    jt, pt = jtopo.ring(6), ptopo.ring(6)
    cfg = dict(K=2, compressor="kernel_quant", comp_bits=4, comp_block=128)
    key = jax.random.PRNGKey(0)
    js, jm = jeng.run_async(jb.problem, jt, J.C2DFBConfig(**cfg), jb.x0, jb.y0, 3, key, jfab.make_fabric(jt, **GEO),
                            policy="bounded", bound=1)
    steps = _per_step(monkeypatch, record_quant_margins(monkeypatch))
    src = JaxReplay(async_run_leaf_keys(key, 3, 2, 1), m=6)
    ps, pm = peng.run_async(pb.problem, pt, P.C2DFBConfig(**cfg), pb.x0, pb.y0, 3, src,
                            fabric=pfab.make_fabric(pt, **GEO), policy="bounded", bound=1, device="cpu")
    assert src.draws == 3 * (4 + 4 * 2)  # a round: 4 metering messages, then 4 messages a step
    assert min(steps) > 1e-5  # no sample of a round within 1e-5 of its rounding threshold
    _same_ledger(pm["ledger"], jm["ledger"])
    _same_schedule_metrics(pm, jm)
    _round_metrics_close(pm, jm)
    _close(ps.x, js.x, "x")
    _close(ps.inner_y.d_hat, js.inner_y.d_hat, "y refs")


@pytest.mark.parametrize("rule", ["common", "acked"])
@pytest.mark.parametrize("alg", ["mdbo", "madsbo"])
def test_async_baselines_equal_the_reference(small, alg, rule):
    jb, pb = small
    jt, pt = jtopo.ring(6), ptopo.ring(6)
    jcfg = JB.MDBOConfig(K=3, neumann_N=2) if alg == "mdbo" else JB.MADSBOConfig(K=3, Q=2)
    pcfg = PB.MDBOConfig(K=3, neumann_N=2) if alg == "mdbo" else PB.MADSBOConfig(K=3, Q=2)
    kw = dict(policy="bounded", bound=1, version_rule=rule)
    js, jm = jeng.run_baseline_async(alg, jb.problem, jt, jcfg, jb.x0, jb.y0, 3, jfab.make_fabric(jt, **GEO), **kw)
    ps, pm = peng.run_baseline_async(alg, pb.problem, pt, pcfg, pb.x0, pb.y0, 3, pfab.make_fabric(pt, **GEO),
                                     device="cpu", **kw)
    assert int(np.max(pm["ledger"].max_age())) == 1
    _same_ledger(pm["ledger"], jm["ledger"])
    for k in ("sim_seconds", "wire_bytes"):
        assert np.array_equal(pm[k], jm[k]), k
    for k in ("hypergrad_norm", "x_consensus_err"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(pm["x_node_dist"].numpy(), np.asarray(jm["x_node_dist"]), rtol=RTOL,
                               atol=max(ATOL, _dist_atol(js.x)), err_msg="x_node_dist")
    _close(ps.x, js.x, "x")
    _close(ps.y, js.y, "y")


@pytest.mark.parametrize("alg", ["mdbo", "madsbo"])
def test_async_baselines_blow_up_at_default_steps_like_the_reference(alg):
    """At their default steps MDBO and MADSBO grow without bound on the
    coefficient-tuning task from p = 500 on under bounded staleness, in the
    reference as in the port (tools/baseline_steps.py prints the
    reference's runs at other widths): round 0's hypergradient norm agrees,
    and both runs grow more than a hundredfold in round 1."""
    jb, pb = _bundles(dict(m=10, n=2000, p=500, c=20, h=0.8, seed=0))
    jt, pt = jtopo.ring(10), ptopo.ring(10)
    jcfg, pcfg = (JB.MDBOConfig(), PB.MDBOConfig()) if alg == "mdbo" else (JB.MADSBOConfig(), PB.MADSBOConfig())
    kw = dict(policy="bounded", bound=1)
    _, jm = jeng.run_baseline_async(alg, jb.problem, jt, jcfg, jb.x0, jb.y0, 2, jfab.make_fabric(jt, **GEO), **kw)
    _, pm = peng.run_baseline_async(alg, pb.problem, pt, pcfg, pb.x0, pb.y0, 2, pfab.make_fabric(pt, **GEO),
                                    device="cpu", **kw)
    jh, ph = np.asarray(jm["hypergrad_norm"]), pm["hypergrad_norm"].numpy()
    np.testing.assert_allclose(ph[0], jh[0], rtol=RTOL)
    assert jh[1] > 100 * jh[0] and ph[1] > 100 * ph[0], (jh, ph)


# ---------------------------------------------------------------- records and the compute meter


# (run, compute_flops, hbm_bytes): the reference's XLA counts of one round
# body at m = 6, n = 200, p = 30, c = 3, ring, K = 2, top-k at 0.5, geo
# fabric, T = 2.  The masked bodies are a lax.cond there, counted as the
# sum of the sync and the delayed branch; the schedule body is the delayed
# branch alone.
COST_RUNS = {
    "sync_run": 108_000.0, "sync": 216_000.0, "bounded": 216_000.0, "full": 216_000.0, "schedule": 108_000.0,
    "mdbo": 97_200.0, "madsbo": 123_120.0,
}
COST_BYTES = {
    "sync_run": 115_776.0, "sync": 317_952.0, "bounded": 317_952.0, "full": 317_952.0, "schedule": 202_176.0,
    "mdbo": 139_248.0, "madsbo": 178_704.0,
}


def _obs_run(pkg, run, bundle):
    """One T = 2 run of ``run`` with obs on a MemorySink (``pkg`` "j" for the
    reference, "p" for the port); returns the sink and the problem."""
    jt = jtopo.ring(6) if pkg == "j" else ptopo.ring(6)
    fab = (jfab if pkg == "j" else pfab).make_fabric(jt, **GEO)
    o = jobs if pkg == "j" else pobs
    sink = o.MemorySink()
    obs = o.Obs(sink=sink)
    dev = {} if pkg == "j" else dict(device="cpu")
    key = (jax.random.PRNGKey(0),) if pkg == "j" else (None,)
    x0, y0, problem = bundle.x0, bundle.y0, bundle.problem
    eng = jeng if pkg == "j" else peng
    if run in ("mdbo", "madsbo"):
        B = JB if pkg == "j" else PB
        cfg = B.MDBOConfig(K=2, neumann_N=2) if run == "mdbo" else B.MADSBOConfig(K=2, Q=2)
        eng.run_baseline_async(run, problem, jt, cfg, x0, y0, 2, fab, policy="bounded", bound=1, obs=obs, **dev)
        return sink
    C = J.C2DFBConfig if pkg == "j" else P.C2DFBConfig
    if run == "sync_run":  # the synchronous run(obs=), no fabric
        (J if pkg == "j" else P).run(problem, jt, C(**SMALL_CFG), x0, y0, T=2, **(
            dict(key=key[0]) if pkg == "j" else dev), obs=obs)
        return sink
    sched = {}
    if run == "schedule":
        sched = dict(schedule=(jdyn if pkg == "j" else pdyn).LinkDropoutSchedule(jt, p_drop=0.2, seed=0))
    policy = "bounded" if run == "schedule" else run
    eng.run_async(problem, jt, C(**SMALL_CFG), x0, y0, 2, *key, fabric=fab, policy=policy, bound=1, obs=obs,
                  **sched, **dev)
    return sink


def _assert_rows_match(prow, jrow, what, dist_atol=ATOL):
    assert set(prow) == set(jrow), what
    for k, jv in jrow.items():
        pv = prow[k]
        floats = isinstance(jv, float) or (isinstance(jv, list) and any(isinstance(v, float) for v in jv))
        if floats and k not in EXACT_FLOATS:
            atol = max(ATOL, dist_atol) if k == "x_dist" else ATOL
            np.testing.assert_allclose(pv, jv, rtol=RTOL, atol=atol, err_msg=f"{what} {k}")
        else:
            assert pv == jv, (what, k, pv, jv)


@pytest.mark.parametrize("run", sorted(COST_RUNS))
def test_async_records_and_compute_meter_equal_the_reference(small, run, monkeypatch):
    """Round and node records' parity views are equal (floats within the
    tolerance), and compute_flops / hbm_bytes equal the reference's XLA
    counts exactly.  The meter runs no extra round: the problem's oracle
    counter holds the run's own calls only.  These bodies exchange nothing:
    the round cost's ``collective_bytes`` is 0.0, the reference's HLO walk
    (read from its round-cost memo)."""
    from repro.obs import compute as jcompute

    jb, pb = small
    jcompute.reset_cost_cache()
    jsink = _obs_run("j", run, jb)
    want = [c.collective_bytes for c in jcompute._COST_CACHE.values()]
    got = []
    for mod, name in ((P, "round_cost"), (peng, "async_round_cost"), (peng, "baseline_round_cost")):
        def keeping(*args, _fn=getattr(mod, name), **kw):
            out, cost = _fn(*args, **kw)
            got.append(cost.collective_bytes)
            return out, cost

        monkeypatch.setattr(mod, name, keeping)
    pb.problem.oracle_calls.clear()
    psink = _obs_run("p", run, pb)
    assert got == want == [0.0] and isinstance(got[0], float)
    for kind in ("round", "node"):
        jrows, prows = jobs.parity_rows(jsink.records, kind=kind), pobs.parity_rows(psink.records, kind=kind)
        assert len(prows) == len(jrows) == (2 if kind == "round" else 12)
        for p, j in zip(prows, jrows):
            _assert_rows_match(p, j, f"{run} {kind} {p['round']}", _dist_atol(jb.x0))
    for p in pobs.parity_rows(psink.records):
        assert (p["compute_flops"], p["hbm_bytes"]) == (COST_RUNS[run], COST_BYTES[run])
    labels = [r["label"] for r in psink.rows(kind="timing")]
    assert labels == [r["label"] for r in jsink.rows(kind="timing")]
    assert labels == (["cost_analysis", "scan"] if run == "sync_run" else ["cost_analysis"])
    if run not in ("mdbo", "madsbo"):
        per = pobs.c2dfb_oracle_calls(P.C2DFBConfig(**SMALL_CFG))
        assert pb.problem.oracle_calls == {"ul_grad": 3 + 2 * per["ul_grad"], "ll_grad": 2 + 2 * per["ll_grad"]}


def test_a_fresh_run_builds_its_round_body_once(small):
    _, pb = small
    pt = ptopo.ring(6)
    peng.reset_trace_counts()
    cache = {}
    for _ in range(2):
        peng.run_async(pb.problem, pt, P.C2DFBConfig(**SMALL_CFG), pb.x0, pb.y0, 3,
                       fabric=pfab.make_fabric(pt, **GEO), fn_cache=cache, device="cpu")
    assert peng.trace_counts() == {"c2dfb_round": 1}
    peng.run_baseline_async("mdbo", pb.problem, pt, PB.MDBOConfig(K=2, neumann_N=2), pb.x0, pb.y0, 2,
                            pfab.make_fabric(pt, **GEO), device="cpu")
    assert peng.trace_counts() == {"c2dfb_round": 1, "mdbo_round": 1}


# ---------------------------------------------------------------- inner_loop(fabric=)


@pytest.mark.parametrize("compressor", ["topk", "kernel_quant"])
def test_inner_loop_priced_by_a_fabric_equals_the_reference(small, compressor):
    """The loop's K steps, then its final residuals measured and priced as
    K barrier phases x 2 messages: wire bytes and simulated seconds equal,
    the loop's own draws and the metering's replayed from the reference's
    key."""
    jb, pb = small
    jt, pt = jtopo.ring(6), ptopo.ring(6)
    cfg = dict(K=3, compressor=compressor, comp_ratio=0.3, comp_bits=4, comp_block=128)
    jc, pc = J.C2DFBConfig(**cfg), P.C2DFBConfig(**cfg)
    jstate, pstate = J.init_state(jb.problem, jc, jb.x0, jb.y0), P.init_state(pb.problem, pc, pb.x0, pb.y0)
    jg = lambda d: jb.problem.grad_y_g()(d, jb.x0)  # noqa: E731
    pg = lambda d: pb.problem.grad_y_g()(d, pb.x0)  # noqa: E731
    key = jax.random.PRNGKey(4)
    kw = dict(profile="wan", straggler="lognormal", sigma=0.6, compute_s=0.02, seed=0)
    js, jm = jinner.inner_loop(jstate.inner_z, key, jg, jnp.asarray(jt.W, jnp.float32), jc.make_compressor(),
                               0.5, 0.1, 3, fabric=jfab.make_fabric(jt, **kw), round_idx=2)
    src = JaxReplay(inner_loop_fabric_leaf_keys(key, 3, 1), m=6)
    ps, pm = pinner.inner_loop(pstate.inner_z, src, pg, torch.as_tensor(pt.W, dtype=torch.float32),
                               pc.make_compressor(), 0.5, 0.1, 3, fabric=pfab.make_fabric(pt, **kw), round_idx=2)
    assert src.draws == (2 * 3 + 2 if compressor == "kernel_quant" else 0)
    assert pm["wire_bytes"] == jm["wire_bytes"] and pm["sim_seconds"] == jm["sim_seconds"]
    assert int(pm["msg_bytes"]) == int(jm["msg_bytes"])
    _close(ps.d_hat, js.d_hat, "d_hat")
    _close(ps.s, js.s, "s")
    from repro_torch.transport import SimTransport

    _, tm = pinner.inner_loop(pstate.inner_z, JaxReplay(inner_loop_fabric_leaf_keys(key, 3, 1), m=6), pg,
                              torch.as_tensor(pt.W, dtype=torch.float32), pc.make_compressor(), 0.5, 0.1, 3,
                              transport=SimTransport(pfab.make_fabric(pt, **kw)).bind(pt), round_idx=2)
    assert (tm["wire_bytes"], tm["sim_seconds"]) == (pm["wire_bytes"], pm["sim_seconds"])
    with pytest.raises(ValueError, match="fabric OR transport"):
        pinner.inner_loop(pstate.inner_z, src, pg, torch.as_tensor(pt.W, dtype=torch.float32),
                          pc.make_compressor(), 0.5, 0.1, 1, fabric=pfab.make_fabric(pt, **kw),
                          transport=pfab.make_fabric(pt, **kw))


def test_sim_transport_prices_like_the_reference():
    """The transport seam the scheduler reads arrivals through: the pricing
    face delegates to the fabric, and ``exchange`` delivers by identity
    with the codec's bytes and the phase's simulated duration equal to the
    reference's; a lazily built fabric equals a given one."""
    from repro.transport import SimTransport as JSim
    from repro.transport import as_transport as j_as
    from repro_torch.transport import SimTransport as PSim
    from repro_torch.transport import as_transport as p_as

    jt, pt = jtopo.ring(6), ptopo.ring(6)
    kw = dict(profile="wan", straggler="lognormal", sigma=0.6, compute_s=0.02, seed=0)
    rng = np.random.default_rng(5)
    payload = {"w": (rng.normal(size=(6, 30)) * (rng.random((6, 30)) < 0.4)).astype(np.float32)}
    edges = jfab.edge_list(jt)[:7]
    jtr, ptr = JSim(jfab.make_fabric(jt, **kw)).bind(jt), PSim(profile="wan", straggler="lognormal", sigma=0.6,
                                                             compute_s=0.02, seed=0).bind(pt)
    for name in (None, "topk", "quant"):
        jc = None if name is None else J.C2DFBConfig(compressor=name, comp_ratio=0.3).make_compressor()
        pc = None if name is None else P.C2DFBConfig(compressor=name, comp_ratio=0.3).make_compressor()
        for e in (None, edges):
            jd, jrep = jtr.exchange(jax.tree.map(jnp.asarray, payload), jc, round_idx=1, phase_idx=2, label="x", edges=e)
            pd, prep = ptr.exchange(from_numpy(payload), pc, round_idx=1, phase_idx=2, label="x", edges=e)
            assert dataclasses.asdict(prep) == dataclasses.asdict(jrep), name
            assert torch.equal(pd["w"], from_numpy(payload)["w"])
    assert not ptr.executes and ptr.egress_s(1000) == jtr.egress_s(1000)
    assert ptr.round_rng(3, 0xA5).random() == jtr.round_rng(3, 0xA5).random()
    fab = pfab.make_fabric(pt, **kw)
    assert p_as(None) is None and p_as(fab).fabric is fab and j_as(None) is None
    with pytest.raises(ValueError, match="not bound"):
        PSim(profile="wan").topo
    with pytest.raises(ValueError, match="bound to topology"):
        PSim(fab).bind(ptopo.ring(5))


# ---------------------------------------------------------------- refusals


def _refusals(pb):
    pt = ptopo.ring(6)
    fab = pfab.make_fabric(pt, **GEO)
    cfg = P.C2DFBConfig(**SMALL_CFG)
    run = lambda **kw: P.run(pb.problem, pt, cfg, pb.x0, pb.y0, T=1, device="cpu", **kw)  # noqa: E731
    return {
        "async without a fabric": (lambda: run(async_mode="bounded"), "requires a NetworkFabric"),
        "version_rule without async": (lambda: run(version_rule="acked", fabric=fab), "async protocol choice"),
        "damping without async": (lambda: run(mixing_damping="inverse-age"), "staleness policy"),
        "compiled async": (lambda: PA.run_async_compiled(pb.problem, pt, cfg, pb.x0, pb.y0, 1, fabric=fab,
                                                         mixing_damping="linear", device="cpu"),
                           "unknown mixing_damping"),
        "compiled sync": (lambda: run(compiled=True), "ASYNC runtime's two-phase scan"),
        "compiled baseline": (lambda: peng.run_baseline_async("f2sa", pb.problem, pt, None, pb.x0, pb.y0, 1, fab,
                                                              compiled=True, device="cpu"), "unknown async baseline"),
        "transport": (lambda: run(transport=fab), "transport= takes a repro_torch.transport.Transport"),
        "unknown damping": (lambda: run(async_mode="full", fabric=fab, mixing_damping="linear"),
                            "unknown mixing_damping"),
        "unknown payload": (lambda: peng.run_async(pb.problem, pt, cfg, pb.x0, pb.y0, 1, fabric=fab,
                                                   payload_bytes="guess", device="cpu"), "unknown payload_bytes"),
        "full with deterministic": (lambda: run(async_mode="full", fabric=fab, version_rule="deterministic"),
                                    "needs a gated policy"),
        "unknown baseline": (lambda: peng.run_baseline_async("f2sa", pb.problem, pt, None, pb.x0, pb.y0, 1, fab,
                                                             device="cpu"), "unknown async baseline"),
    }


REFUSALS = (
    "async without a fabric", "version_rule without async", "damping without async", "compiled async",
    "compiled sync", "compiled baseline", "transport", "unknown damping", "unknown payload",
    "full with deterministic", "unknown baseline",
)


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_raise_named_value_errors(small, case):
    fn, match = _refusals(small[1])[case]
    with pytest.raises(ValueError, match=match):
        fn()
