"""The reference's async regression gate (m = 6, K = 4, T = 12, geo with
lognormal stragglers, top-k at 0.5) on the port's eager asynchronous
engine against LIVE runs of the JAX reference, round by round on the
reference's states and end to end (tests/test_torch_async.py's method and
helpers).  This file holds the rows bounded1 and bounded1_acked;
tests/test_torch_async_gate_sync_full.py holds sync, full and
bounded1_det.  About 200 s on one worker."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.async_gossip as PA
import repro_torch.obs as pobs
from repro.async_gossip import engine as jeng
from repro.core import c2dfb as J
from repro.core import inner_loop as jinner
from repro.core import topology as jtopo
from repro.net import fabric as jfab
from repro_torch.async_gossip import engine as peng
from repro_torch.core import c2dfb as P
from repro_torch.core import inner_loop as pinner
from repro_torch.core import topology as ptopo
from repro_torch.core.convert import from_numpy
from repro_torch.net import fabric as pfab
from test_torch_async import (
    ATOL,
    GEO,
    RTOL,
    _bundles,
    _close,
    _per_step,
    _round_metrics_close,
    _same_ledger,
    _same_schedule_metrics,
)


GATE_TASK = dict(m=6, n=300, p=40, c=5, h=0.8, seed=0)
GATE_CFG = dict(lam=10.0, eta_out=0.3, gamma_out=0.5, eta_in=0.3, gamma_in=0.3, K=4, compressor="topk", comp_ratio=0.5)
GATE_T = 12
GATE_ROWS = {  # label: (policy, bound, version rule)
    "sync": ("sync", 0, "common"),
    "bounded1": ("bounded", 1, "common"),
    "full": ("full", 0, "common"),
    "bounded1_det": ("bounded", 1, "deterministic"),
    "bounded1_acked": ("bounded", 1, "acked"),
}
# the reference's wire bytes over the T = 12 rounds.  Analytic sizes do not
# depend on the trajectory; measured ones count each round's residual
# nonzeros, so a port run that parted from the reference at a top-k
# near-tie may price later rounds differently (at `full` the port's own
# run totals 1,757,856): the port is held to these totals on the
# reference's own states, round by round.
GATE_WIRE = {
    "analytic": {"sync": 1_911_456, "bounded1": 1_911_456, "full": 1_911_456, "bounded1_det": 1_911_456,
                 "bounded1_acked": 1_920_672},
    "measured": {"sync": 1_757_856, "bounded1": 1_757_856, "full": 1_757_792, "bounded1_det": 1_757_856,
                 "bounded1_acked": 1_767_072},
}
# relative top-k margin below which the two packages may keep different
# coordinates: their residuals differ by BLAS order; at the gate config the
# selections parted at gaps of 3.1e-6 (sync, round 2) and 4.2e-6 (full,
# round 6), never at 9.3e-6 or more
TIE = 5e-6


@pytest.fixture(scope="module")
def gate_bundles():
    return _bundles(GATE_TASK)


def _row_margins(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Per row of ``flat``, the relative gap between the k-th and the
    (k+1)-th magnitude (the margin of top-k's selection); inf on a row
    with fewer than k nonzeros (it keeps all of them, whatever the
    order)."""
    a = torch.sort(torch.abs(flat), dim=-1, descending=True).values
    kth, nxt = a[..., k - 1], a[..., k]
    live = kth > 0
    return torch.where(live, (kth - nxt) / torch.where(live, kth, 1.0), torch.inf)


def _record_topk_margins(monkeypatch) -> list:
    """Per compression, the smallest top-k margin over its rows."""
    import repro_torch.core.compression as pcomp

    margins = []
    keep = pcomp._keep_topk

    def recording(flat, k):
        if k < flat.shape[-1] and not flat.is_meta:  # a meta tensor (the cost meter's count) holds no values
            mins = float(_row_margins(flat, k).min())
            if mins < float("inf"):
                margins.append(mins)
        return keep(flat, k)

    monkeypatch.setattr(pcomp, "_keep_topk", recording)
    return margins


# the gate rows' reference runs share their jitted round bodies (one a
# history depth; the keys hold the ids of GATE_JT and the module's problem,
# which live as long as the module), and their debug callbacks append to
# _REF_STEPS, which each run clears
_GATE_JIT_CACHE: dict = {}
_REF_STEPS: list = []
GATE_JT = jtopo.ring(6)


def _record_reference_rounds(monkeypatch) -> list:
    """Record every round the reference's run executes: its input state,
    ages, output state and metrics, and for each of its inner steps'
    compressions (d then s, leaves in order) the residual and the
    coordinates top-k kept (the nonzeros of the transmitted q), read out of
    the jitted body by debug callbacks."""
    rounds, steps = [], _REF_STEPS
    steps.clear()
    apply = jinner.inner_apply

    def recording_apply(st, *args):
        st2, (q_d, q_s) = apply(st, *args)
        resid = [jnp.subtract(a, b) for tv, tr in ((st2.d, st.d_hat), (st2.s, st.s_hat))
                 for a, b in zip(jax.tree.leaves(tv), jax.tree.leaves(tr))]
        qs = jax.tree.leaves(q_d) + jax.tree.leaves(q_s)
        jax.debug.callback(lambda *a: _REF_STEPS.append([(np.asarray(r), np.asarray(q) != 0) for r, q in
                                                         zip(a[:len(resid)], a[len(resid):])]),
                           *resid, *qs, ordered=True)
        return st2, (q_d, q_s)

    monkeypatch.setattr(jinner, "inner_apply", recording_apply)
    monkeypatch.setattr(jeng, "inner_apply", recording_apply)
    build = jeng.cached_jit

    def recording_jit(cache, key, make, **kw):
        fn = build(cache, key, make, **kw)

        def round_fn(st, k, ay, az):
            out = fn(st, k, ay, az)
            jax.effects_barrier()
            rounds.append(dict(state=st, ages=(np.array(ay), np.array(az)), out=out, steps=list(steps)))
            steps.clear()
            return out

        return round_fn

    monkeypatch.setattr(jeng, "cached_jit", recording_jit)
    return rounds


def _force_reference_selection(monkeypatch, keep, forced: list) -> collections.deque:
    """Make the port's top-k keep the coordinates the reference kept, taken
    in order from the returned queue of (reference residual, kept mask)
    pairs, one a compression (an empty queue leaves the port's own
    choice).  Where the port's own choice of a row differs, the parting
    must be a near-tie that the packages' rounding decides: with delta the
    row's largest difference between the port's residual and the
    reference's, every magnitude the port alone kept exceeds every one the
    reference alone kept by at most 2 * delta.  Each such row is counted in
    ``forced``; ``queue.calls`` counts every top-k."""
    import repro_torch.core.compression as pcomp

    class Queue(collections.deque):
        calls = 0

    queue = Queue()

    def forcing(flat, k):
        queue.calls += 1
        if not queue:
            return keep(flat, k)
        ref, want = (torch.tensor(a).reshape(flat.shape) for a in queue.popleft())
        own = keep(flat, k) != 0
        for r in torch.nonzero((own != want).any(dim=-1)).flatten().tolist():
            mag = torch.abs(flat[r])
            delta = float(torch.max(torch.abs(flat[r] - ref[r])))
            gap = float(mag[own[r] & ~want[r]].max() - mag[want[r] & ~own[r]].min())
            assert gap <= 2 * delta, f"top-k parted from the reference off a tie: gap {gap}, delta {delta}"
            forced.append(r)
        return flat * want.to(flat.dtype)

    monkeypatch.setattr(pcomp, "_keep_topk", forcing)
    return queue


def _state_trees(s):
    return [s.x, s.s_x, s.u_prev, *s.inner_y, *s.inner_z]


def _gate_row(gate_bundles, label, mode, monkeypatch):
    """`test_gate_rows_equal_the_reference` on the row ``label`` with
    ``mode`` payload sizes."""
    jb, pb = gate_bundles
    policy, bound, rule = GATE_ROWS[label]
    jt, pt = GATE_JT, ptopo.ring(6)
    cfg = P.C2DFBConfig(**GATE_CFG)
    import repro_torch.core.compression as pcomp

    keep = pcomp._keep_topk
    rounds = _record_reference_rounds(monkeypatch)
    js, jm = jeng.run_async(
        jb.problem, jt, J.C2DFBConfig(**GATE_CFG), jb.x0, jb.y0, GATE_T, jax.random.PRNGKey(0),
        jfab.make_fabric(jt, **GEO), policy=policy, bound=bound, version_rule=rule, payload_bytes=mode,
        fn_cache=_GATE_JIT_CACHE,
    )
    assert len(rounds) == GATE_T and int(np.sum(jm["wire_bytes"])) == GATE_WIRE[mode][label]

    # ---- round by round on the reference's states
    sched = PA.AsyncScheduler(pfab.make_fabric(pt, **GEO), policy=policy, bound=bound, version_rule=rule)
    st0 = P.init_state(pb.problem, cfg, pb.x0, pb.y0)
    depth = sched.depth_for(cfg.K)
    comp = cfg.make_compressor()
    const = peng.analytic_message_bytes(st0.inner_y, comp) if mode == "analytic" else None
    forced = []
    queue = _force_reference_selection(monkeypatch, keep, forced)
    total = 0
    for t, r in enumerate(rounds):
        state = from_numpy(r["state"])
        if const is None:
            by, bz = (np.add(*pinner.inner_message_bytes(inner, comp, None), dtype=np.int64)
                      for inner in (state.inner_y, state.inner_z))
        else:
            by = bz = const
        assert len(r["steps"]) == 2 * cfg.K  # one record an inner step
        queue.extend(c for step in r["steps"] for c in step)
        calls = queue.calls + len(queue)
        rt = sched.drive_round(t, cfg.K, by, bz, peng._dense_node_bytes(st0.x), GEO["compute_s"] / (2 * cfg.K + 2))
        assert np.array_equal(rt.tl_y.ages, r["ages"][0]) and np.array_equal(rt.tl_z.ages, r["ages"][1]), t
        wire = rt.tl_y.wire_bytes + rt.tl_z.wire_bytes + rt.outer_wire_bytes
        assert wire == jm["wire_bytes"][t] and rt.t_end - rt.t_start == jm["sim_seconds"][t], t
        total += wire
        out, mets = peng.c2dfb_masked_round(state, None, rt.tl_y.ages, rt.tl_z.ages, problem=pb.problem,
                                            topo=pt, cfg=cfg, depth=depth)
        assert not queue and queue.calls == calls, f"round {t}: the port compressed other than the reference"
        jout, jmets = r["out"]
        for got, want in zip(_state_trees(out), _state_trees(jout)):
            _close(got, want, f"round {t}")
        assert set(mets) == set(jmets)
        for k, v in mets.items():
            if k == "measured_bytes":
                assert int(v) == int(jmets[k]), (t, k)
            else:
                np.testing.assert_allclose(v.numpy(), np.asarray(jmets[k]), rtol=RTOL, atol=ATOL,
                                           err_msg=f"round {t} {k}")
    assert total == GATE_WIRE[mode][label]
    assert len(forced) <= 2  # a run's rows sit on a near-tie once or twice at most

    # ---- the whole run through run(async_mode=), free of the reference
    monkeypatch.setattr(pcomp, "_keep_topk", keep)
    steps = _per_step(monkeypatch, _record_topk_margins(monkeypatch))
    sink = pobs.MemorySink()
    if mode == "measured":
        ps, pm = P.run(pb.problem, pt, cfg, pb.x0, pb.y0, T=GATE_T, device="cpu",
                       fabric=pfab.make_fabric(pt, **GEO), async_mode=policy, staleness_bound=bound,
                       version_rule=rule, obs=pobs.Obs(sink=sink))
    else:  # run() always meters; the analytic timing model is run_async's
        ps, pm = peng.run_async(pb.problem, pt, cfg, pb.x0, pb.y0, GATE_T,
                                fabric=pfab.make_fabric(pt, **GEO), policy=policy, bound=bound,
                                version_rule=rule, payload_bytes=mode, obs=pobs.Obs(sink=sink), device="cpu")
    per_round = 2 * GATE_CFG["K"]  # inner steps a round, each two compressions
    assert len(steps) == GATE_T * per_round
    tie = next((t for t in range(GATE_T) if min(steps[t * per_round:(t + 1) * per_round]) < TIE), GATE_T)
    assert tie >= 2
    # the scheduler's side: ages and seconds on every round (analytic sizes
    # do not depend on the trajectory; measured ones through the near-tie
    # round, metered on the state before it); the trajectory before it
    rounds_equal = None if mode == "analytic" else tie + 1
    _same_ledger(pm["ledger"], jm["ledger"], rounds_equal, tie)
    _same_schedule_metrics(pm, jm, rounds_equal)
    _round_metrics_close(pm, jm, tie)
    calls = {}
    for r in sink.rows(kind="round"):
        for k, v in r["oracle_calls"].items():
            calls[k] = calls.get(k, 0) + v
    assert calls == {"ul_grad": 216, "ll_grad": 720, "hvp": 0, "jvp": 0}
    if tie == GATE_T:
        _close(ps.x, js.x, "x")


@pytest.mark.parametrize("mode", ["analytic", "measured"])
@pytest.mark.parametrize("label", ["bounded1", "bounded1_acked"])
def test_gate_rows_equal_the_reference(gate_bundles, label, mode, monkeypatch):
    """The reference's async regression gate (m = 6, K = 4, T = 12, geo with
    lognormal stragglers, top-k at 0.5).

    Round by round: every round the port meters, schedules and runs its
    round body on the reference's own input state.  Ages and wire bytes
    are equal on all 12 rounds (their totals are the gate's), the output
    state and the metrics agree within the golden tolerance and the
    round's measured bytes are equal; top-k keeps the reference's
    coordinates, which may differ from the port's only on a row whose
    margin is a near-tie.

    Through ``run(async_mode=)`` end to end: the ledger, ages, histograms,
    staleness, simulated seconds and wire bytes equal the reference's
    wherever the trajectories have not parted at a near-tie (all rounds
    for analytic sizes), the trajectory agrees before the first one, and
    the oracle calls are the gate's."""
    _gate_row(gate_bundles, label, mode, monkeypatch)
