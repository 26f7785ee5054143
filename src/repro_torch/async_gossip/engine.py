"""Async execution engine: C2DFB (and the baselines) under staleness
(``repro.async_gossip.engine``'s counterpart, the eager half).

Couples the three halves of the subsystem:

* `scheduler.AsyncScheduler` (host numpy) turns the fabric's link /
  straggler timelines into per-step, per-edge version AGES;
* `mixing.mix_delta_delayed` (device) gates the mixing matrix with those
  ages;
* `ledger.StalenessLedger` keeps the ages and the consensus-vs-seconds
  curve as first-class round metrics.

The outer loop runs round by round: each round the current residuals are
serialized by the wire codec to get honest per-node packet sizes, the
scheduler executes the two inner loops event-driven (outer x / s_x
broadcasts stay barrier-synchronized — Algorithm 1's round boundary, which
also drains in-flight residuals so the next round's version-0 references
are globally consistent), and the resulting age tensors go to the device
with the round.

Rounds whose age tensors are all zero take a fast path that is
OP-IDENTICAL to the synchronous `c2dfb_round`, so a zero-latency fabric
reproduces the synchronous trajectory bit for bit.  Where the reference
selects it with a ``lax.cond`` inside one jitted body, the port selects it
with a Python branch on the host ages the scheduler returns, before they
move to the device: choosing it costs no device sync.

Random draws.  A run draws from one source (``generator``).  With
``payload_bytes="measured"`` round t first meters its packet sizes (the y
loop's d and s messages, then the z loop's), then runs its own draws
(`repro_torch.core.compression`'s order); the reference draws the metering
from ``split(fold_in(keys[t], 0xB17E))``.  The analytic probe draws from a
source of its own and never advances the run's.

The compiled runtime (one scan over all rounds) is not ported yet:
``compiled=True`` raises.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.async_gossip.ledger import (
    StalenessLedger,
    edge_age_samples,
    node_staleness_stats,
    staleness_stats,
)
from repro_torch.async_gossip.mixing import (
    DelayedMixer,
    init_history,
    mix_delta_delayed,
    push_history,
    validate_damping,
)
from repro_torch.async_gossip.scheduler import AsyncScheduler
from repro_torch.core.baselines import madsbo_init, madsbo_round_async, mdbo_init, mdbo_round_async
from repro_torch.core.bilevel_problem import BilevelProblem
from repro_torch.core.c2dfb import (
    C2DFBConfig,
    C2DFBState,
    _mixing_matrix,
    c2dfb_round_core,
    init_state,
    run_device,
)
from repro_torch.core.compression import make_compressor
from repro_torch.core.inner_loop import InnerState, inner_loop, inner_message_bytes
from repro_torch.core.topology import Topology
from repro_torch.core.types import Tree, tree_leaves, tree_map
from repro_torch.net.dynamic import active_edge_masks, schedule_version_lags, validate_schedule_stack
from repro_torch.net.fabric import edge_list
from repro_torch.net.wire import codec_for, measure_tree_bytes
from repro_torch.obs.compute import (
    MetaSource,
    c2dfb_oracle_calls,
    memory_peak_bytes,
    meta_cost,
    oracle_calls_for,
    round_cost,
)
from repro_torch.obs.core import as_obs
from repro_torch.transport.base import as_transport

#: Payload-size models for the eager engine: "measured" serializes the
#: CURRENT residuals every round (codec truth, byte-accurate timing),
#: "analytic" prices every round with the constant
#: `analytic_message_bytes` size (the compiled runtime's timing model).
PAYLOAD_MODES = ("measured", "analytic")

COMPILED_NOT_PORTED = (
    "compiled=True selects the asynchronous engine's compiled runtime "
    "(ROADMAP item A8b: one scan over all rounds from a scheduler replay), "
    "which the port does not have yet; drop compiled to run the eager engine"
)

# ---------------------------------------------------------------------------
# build accounting + the one keyed cache every engine path shares
# ---------------------------------------------------------------------------

#: build counters: a round body built again shows up as an increment, so a
#: test can assert a run builds each body once (the reference counts jit
#: traces under the same names)
_TRACE_COUNTS: dict[str, int] = {}


def record_trace(name: str) -> None:
    """Bump a named build counter (called once when a round body is built)."""
    _TRACE_COUNTS[name] = _TRACE_COUNTS.get(name, 0) + 1


def trace_counts() -> dict[str, int]:
    """Snapshot of the per-body build counters."""
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    _TRACE_COUNTS.clear()


@contextmanager
def preserve_trace_counts():
    """Snapshot and restore the build counters around bookkeeping work that
    must not show up as a rebuild."""
    saved = dict(_TRACE_COUNTS)
    try:
        yield
    finally:
        _TRACE_COUNTS.clear()
        _TRACE_COUNTS.update(saved)


def cached_jit(cache: dict, key: tuple, build):
    """The ONE keyed cache of round bodies for every engine path (C2DFB,
    MADSBO, MDBO): ``build()`` is called once per ``key`` and its callable
    memoized in ``cache``.  The port runs eagerly, so nothing is compiled;
    the name and the key discipline are the reference's: keys carry
    ``id(problem)`` / ``id(topo)`` plus the config and policy knobs, so
    callers that share a cache across runs (``fn_cache=``) share bodies
    exactly when the body would be the same."""
    fn = cache.get(key)
    if fn is None:
        fn = cache[key] = build()
    return fn


def _built(name: str, fn):
    """A round body at its build: counted once under ``name``."""
    record_trace(name)
    return fn


#: analytic packet sizes depend only on (compressor spec, leaf shapes) —
#: memoized so repeated runs skip the probe's compress + serialize pass
_ANALYTIC_BYTES_CACHE: dict = {}


def analytic_message_bytes(inner: InnerState, compressor) -> int:
    """Per-node steady-state wire bytes of one inner step's two messages
    (d- and s-residual), from the compression SPEC alone: a dense all-ones
    probe residual is compressed and serialized by the wire codec
    (`repro_torch.net.wire.measure_tree_bytes`).  Every shipped format is
    size-deterministic on a dense probe, so this is the exact steady-state
    packet size without touching run-time values.  A stochastic compressor
    draws the probe from a source of its own (seeded 0), never from the
    run's."""
    leaves = tree_leaves(inner.d_hat)
    try:
        ckey = (compressor, tuple((tuple(v.shape[1:]), str(v.dtype)) for v in leaves))
        cached = _ANALYTIC_BYTES_CACHE.get(ckey)
        if cached is not None:
            return cached
    except TypeError:  # unhashable custom compressor: just measure
        ckey = None
    device = leaves[0].device
    probe = tree_map(lambda v: torch.ones_like(v[0]), inner.d_hat)
    q = compressor.compress_tree(probe, torch.Generator(device=device).manual_seed(0))
    nbytes = 2 * measure_tree_bytes(compressor, q)
    if ckey is not None:
        _ANALYTIC_BYTES_CACHE[ckey] = nbytes
    return nbytes


def async_inner_loop(
    state: InnerState,
    generator,
    grad_fn,
    W: torch.Tensor,
    compressor,
    gamma: float,
    eta: float,
    K: int,
    ages: torch.Tensor | None,
    depth: int,
    delayed: bool = True,
    damping: str = "none",
    decay: float = 0.5,
    hist0: tuple | None = None,
    return_hist: bool = False,
) -> tuple:
    """Algorithm 2 under staleness: K steps where the mixing deltas come
    from age-gated reference HISTORIES instead of the current references.

    ``ages`` is a (K, m, m) integer tensor on the state's device — step k
    mixes edge (i, j) on the common version of age ``ages[k, i, j]``.  With
    ``delayed=False`` (all ages zero) this IS the synchronous `inner_loop`,
    so zero-staleness rounds are bit-identical to the sync path and carry
    no dead history.

    ``damping`` applies the staleness-adaptive weight policy per step on
    the realized ages.  ``hist0`` (a ``(hist_d, hist_s)`` pair) seeds the
    reference histories instead of re-initializing them from the current
    references — the schedule-composed engine carries histories ACROSS
    rounds so edges that sat rounds out still mix their true, frozen
    version.  With ``return_hist`` the post-loop histories come back as a
    third result.

    The delayed branch is `inner_loop` itself with a `DelayedMixer` on
    the histories.
    """
    if not delayed:
        if return_hist:
            raise ValueError("return_hist requires the delayed branch")
        return inner_loop(state, generator, grad_fn, W, compressor, gamma, eta, K)
    # fresh histories go straight to the mixer, unbound here, so each push
    # frees the version it replaces
    hists = hist0 or (init_history(state.d_hat, depth), init_history(state.s_hat, depth))
    mixer = DelayedMixer(W, *hists, ages, damping, decay)
    del hists
    state, metrics = inner_loop(state, generator, grad_fn, W, compressor, gamma, eta, K, mixer=mixer)
    if return_hist:
        return state, metrics, mixer.histories(state)
    return state, metrics


def async_c2dfb_round(
    state: C2DFBState,
    generator,
    problem: BilevelProblem,
    topo: Topology,
    cfg: C2DFBConfig,
    ages_y: torch.Tensor | None,
    ages_z: torch.Tensor | None,
    depth: int,
    delayed: bool = True,
    W: torch.Tensor | None = None,
    damping: str = "none",
    decay: float = 0.5,
    hists: dict | None = None,
) -> tuple:
    """One outer round with staleness-gated inner loops: the shared
    `c2dfb_round_core` body with `async_inner_loop` plugged in.  Outer
    x / s_x updates stay synchronous (the round boundary is a barrier), so
    zero ages reproduce the synchronous round exactly.

    ``W`` overrides the static mixing matrix with a schedule round's
    matrix (outer AND inner mixing).  ``hists`` maps loop tag ("y" / "z")
    to a cross-round ``(hist_d, hist_s)`` history pair; when given, the
    round returns ``(state, metrics, hists_out)``."""
    Wm = _mixing_matrix(topo, state.x) if W is None else W
    compressor = cfg.make_compressor()
    ages = {"y": ages_y, "z": ages_z}
    hists_out: dict = {}

    def inner_fn(st, gen, grad_fn, eta, tag):
        if hists is None:
            return async_inner_loop(
                st, gen, grad_fn, Wm, compressor, cfg.gamma_in, eta, cfg.K,
                ages[tag], depth, delayed, damping=damping, decay=decay,
            )
        st, mets, h = async_inner_loop(
            st, gen, grad_fn, Wm, compressor, cfg.gamma_in, eta, cfg.K,
            ages[tag], depth, delayed, damping=damping, decay=decay,
            hist0=hists[tag], return_hist=True,
        )
        hists_out[tag] = h
        return st, mets

    new_state, metrics = c2dfb_round_core(state, generator, problem, Wm, cfg, inner_fn)
    if hists is None:
        return new_state, metrics
    return new_state, metrics, hists_out


def _dense_node_bytes(tree: Tree) -> int:
    """Per-node dense f32 wire bytes of a node-stacked tree (codec truth)."""
    return codec_for(make_compressor("identity")).tree_bytes(tree_map(lambda v: v[0], tree))


@dataclasses.dataclass(frozen=True)
class _RunPlan:
    """Everything a C2DFB async run fixes BEFORE its first round: the
    (static) history depth, the validated schedule stack and its per-round
    active-edge masks, the re-entry catch-up packet size, the cross-round
    history seed, and whether version lag must be tracked."""

    depth: int
    Ws: object = None           # (T, m, m) validated schedule stack (numpy)
    masks: object = None        # (T, m, m) bool active-edge masks
    catchup_bytes: int = 0
    hists: dict | None = None
    track_lag: bool = False


def _prepare_async_run(scheduler: AsyncScheduler, state, cfg, topo, T: int, schedule) -> _RunPlan:
    """Size the histories and resolve the schedule/lag bookkeeping for a
    run (see `_RunPlan`).  An injected scheduler may carry unresolved
    version lag from a prior schedule-composed run; a static follow-up run
    must honor it — those edges re-enter at their true age with a priced
    catch-up, not silently at age 0."""
    depth = scheduler.depth_for(cfg.K)
    catchup_bytes = 0
    hists = None
    Ws = masks = None
    carried_lag = int(scheduler.version_lag.max())
    if schedule is None and carried_lag > 0:
        catchup_bytes = 2 * _dense_node_bytes(state.inner_y.d_hat)
        depth = scheduler.depth_for(cfg.K, carried_lag)
    if schedule is not None:
        Ws = validate_schedule_stack(schedule.stack(T), T, topo.m, base=topo)
        masks = active_edge_masks(Ws)
        _, max_lag = schedule_version_lags(masks, cfg.K)
        # every realizable age is bounded by the replayed lag plus the
        # carried offset
        depth = scheduler.depth_for(cfg.K, int(max_lag) + carried_lag)
        # re-entering edges exchange both dense reference trees first
        catchup_bytes = 2 * _dense_node_bytes(state.inner_y.d_hat)
        hists = {
            "y": (init_history(state.inner_y.d_hat, depth), init_history(state.inner_y.s_hat, depth)),
            "z": (init_history(state.inner_z.d_hat, depth), init_history(state.inner_z.s_hat, depth)),
        }
    return _RunPlan(
        depth=depth, Ws=Ws, masks=masks, catchup_bytes=catchup_bytes,
        hists=hists, track_lag=schedule is not None or carried_lag > 0,
    )


# ---------------------------------------------------------------------------
# the round bodies
# ---------------------------------------------------------------------------


def _on(ages: np.ndarray, like: Tree) -> torch.Tensor:
    """Host ages as an int32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(ages, dtype=np.int32), device=tree_leaves(like)[0].device)


def _stale(*ages) -> bool:
    """Does any host age array hold a nonzero age?"""
    return any(bool(np.any(a)) for a in ages)


def c2dfb_masked_round(
    state: C2DFBState,
    generator,
    ages_y: np.ndarray,
    ages_z: np.ndarray,
    *,
    problem: BilevelProblem,
    topo: Topology,
    cfg: C2DFBConfig,
    depth: int,
    damping: str = "none",
    decay: float = 0.5,
) -> tuple[C2DFBState, dict]:
    """ONE C2DFB round body for every age pattern: a branch on "any
    nonzero age" in the host ``ages_y`` / ``ages_z`` ((K, m, m) numpy, as
    the scheduler returns them) selects between the delayed round and the
    synchronous fast path, so zero-staleness rounds are bit-identical to
    the sync algorithm (same ops as `inner_loop`)."""
    if not _stale(ages_y, ages_z):
        return async_c2dfb_round(state, generator, problem, topo, cfg, None, None, depth, delayed=False)
    return async_c2dfb_round(
        state, generator, problem, topo, cfg, _on(ages_y, state.x), _on(ages_z, state.x), depth,
        delayed=True, damping=damping, decay=decay,
    )


def c2dfb_schedule_round(
    state: C2DFBState,
    generator,
    W,
    ages_y: np.ndarray,
    ages_z: np.ndarray,
    hists: dict,
    *,
    problem: BilevelProblem,
    topo: Topology,
    cfg: C2DFBConfig,
    depth: int,
    damping: str = "none",
    decay: float = 0.5,
) -> tuple:
    """The schedule-composed round body: the round's W (numpy or a
    tensor), host ages and the cross-round histories; always the delayed
    round (the histories must advance)."""
    Wt = torch.as_tensor(W, dtype=torch.float32, device=tree_leaves(state.x)[0].device)
    return async_c2dfb_round(
        state, generator, problem, topo, cfg, _on(ages_y, state.x), _on(ages_z, state.x), depth,
        delayed=True, W=Wt, damping=damping, decay=decay, hists=hists,
    )


def _meta_ages(steps: int, m: int) -> torch.Tensor:
    return torch.empty((steps, m, m), dtype=torch.int32, device="meta")


def async_round_cost(
    problem: BilevelProblem,
    topo: Topology,
    cfg: C2DFBConfig,
    plan: _RunPlan,
    mixing_damping: str,
    damping_decay: float,
    state: C2DFBState,
    generator,
    body,
    *args,
):
    """Run round 0's body ``body(state, generator, *args)`` (the masked or
    the schedule body) under the counters and return its result with the
    round body's `RoundCost`, as the reference's XLA cost analysis counts
    it: the schedule body is the delayed round alone; the masked body is a
    ``lax.cond`` there, whose two branches XLA adds up, so the branch that
    round 0 did not take is counted on the meta device (`meta_cost`: shapes
    only, no execution, no draw from the run's source).  The counted round
    is the run's own round 0: no extra round runs on real data."""
    expected = c2dfb_oracle_calls(cfg)
    out, cost = round_cost(body, state, generator, *args, expected_oracles=expected, label="c2dfb")
    if plan.Ws is not None:
        return out, cost
    took_delayed = _stale(*args[:2])
    ages = _meta_ages(cfg.K, topo.m) if not took_delayed else None
    other = meta_cost(
        lambda st, pb: async_c2dfb_round(
            st, MetaSource(), pb, topo, cfg, ages, ages, plan.depth, delayed=not took_delayed,
            damping=mixing_damping, decay=damping_decay,
        ),
        state, problem,
    )
    return out, cost.plus(other)


def baseline_round_cost(alg: str, problem, topo, cfg, depth: int, damping: str, decay: float, state, *ages):
    """`async_round_cost`'s MADSBO/MDBO twin: run round 0's
    `baseline_masked_round` under the counters, and count the branch it
    did not take on the meta device; returns (result, `RoundCost`)."""
    expected = oracle_calls_for(alg, cfg)
    kw = dict(problem=problem, topo=topo, cfg=cfg, depth=depth, damping=damping, decay=decay)
    out, cost = round_cost(
        lambda st: baseline_masked_round(alg, st, *ages, **kw), state, expected_oracles=expected, label=alg
    )
    took_delayed = _stale(*ages)
    m = topo.m
    meta = [_meta_ages(a.shape[0], m) for a in ages] if not took_delayed else [None] * len(ages)
    other = meta_cost(
        lambda st, pb: _baseline_round(alg, st, pb, topo, cfg, meta, depth, not took_delayed, damping, decay),
        state, problem,
    )
    return out, cost.plus(other)


def _stack_rows(rows: list[dict]) -> dict:
    """Per-round rows -> metrics stacked over rounds: the round body's
    tensors stay tensors on the run's device (a leading axis of T), the
    scheduler's host values become numpy arrays."""
    if not rows:
        return {}
    return {
        k: torch.stack([r[k] for r in rows]) if torch.is_tensor(rows[0][k]) else np.stack([r[k] for r in rows])
        for k in rows[0]
    }


def run_async(
    problem: BilevelProblem,
    topo: Topology,
    cfg: C2DFBConfig,
    x0: Tree,
    y0: Tree,
    T: int,
    generator=None,
    fabric=None,
    policy: str = "bounded",
    bound: int = 2,
    version_rule: str = "common",
    ledger: StalenessLedger | None = None,
    scheduler: AsyncScheduler | None = None,
    schedule=None,
    mixing_damping: str = "none",
    damping_decay: float = 0.5,
    payload_bytes: str = "measured",
    fn_cache: dict | None = None,
    obs=None,
    device: str | torch.device | None = None,
) -> tuple[C2DFBState, dict]:
    """T outer rounds of C2DFB under the async engine, on one device
    (``cuda`` unless ``device="cpu"``; the problem's data and x0/y0 must lie
    there).  ``generator`` is the run's random source (see the module
    docstring for its draw order); ``fabric`` a
    `repro_torch.net.fabric.NetworkFabric` or a `Transport`.

    ``obs`` (a `repro_torch.obs.Obs` or bare sink) streams one record per
    round — the shared `repro_torch.obs.records` schema, with bytes split by
    stream, staleness stats, simulated and host wall seconds, the build
    counters, the fleet's oracle calls and round 0's ``compute_flops`` and
    ``hbm_bytes`` (`async_round_cost`) — and m node records a round, as the
    round completes.

    Returns the final state and per-round metrics: the synchronous
    ``run``'s keys (tensors with a leading axis of T on the run's device)
    plus host numpy arrays ``sim_seconds``, ``wire_bytes`` (per-link
    accounting from the scheduler), ``staleness_max`` / ``staleness_mean``
    (active directed edges only) and ``staleness_hist`` (T, depth), and the
    ``ledger``.  ``policy="sync"`` is the barrier reference; "bounded"
    enforces ``age <= bound`` by gating; "full" never waits.

    ``payload_bytes`` selects the timing model's packet sizes
    (`PAYLOAD_MODES`).  ``fn_cache`` shares the round bodies across runs
    (see `cached_jit`).  ``version_rule`` selects which version an edge
    mixes (the scheduler's `VERSION_RULES`); ignored when an explicit
    ``scheduler`` is injected.  ``schedule`` (a
    `repro_torch.net.dynamic.TopologySchedule`) composes the engine with
    per-round mixing matrices: an edge that sits rounds out freezes its
    reference history and re-enters with its true version age, paying a
    dense catch-up before in-round residuals apply; reference histories
    are carried ACROSS rounds.  ``mixing_damping`` selects the
    staleness-adaptive weight policy (`mixing.DAMPING_POLICIES`).
    """
    obs = as_obs(obs)
    validate_damping(mixing_damping)
    if payload_bytes not in PAYLOAD_MODES:
        raise ValueError(f"unknown payload_bytes {payload_bytes!r}; have {PAYLOAD_MODES}")
    device = run_device(problem, x0, y0, device)
    # accept a Transport wherever a fabric is accepted; the scheduler
    # consumes arrival times through the transport face either way
    transport = as_transport(fabric)
    if transport is not None:
        transport.bind(topo)
        fabric = transport.fabric
    scheduler = scheduler or AsyncScheduler(transport, policy=policy, bound=bound, version_rule=version_rule)
    ledger = ledger if ledger is not None else StalenessLedger()
    state = init_state(problem, cfg, x0, y0)
    comp = cfg.make_compressor()
    outer_node_bytes = _dense_node_bytes(state.x)
    compute_step = fabric.compute_s / (2 * cfg.K + 2) if fabric.compute_s else 0.0
    edges = edge_list(topo)
    plan = _prepare_async_run(scheduler, state, cfg, topo, T, schedule)
    depth = plan.depth
    hists = plan.hists
    const_bytes = analytic_message_bytes(state.inner_y, comp) if payload_bytes == "analytic" else None

    cache = fn_cache if fn_cache is not None else {}
    ckey = (id(problem), id(topo), cfg, depth, mixing_damping, damping_decay)
    body_kw = dict(problem=problem, topo=topo, cfg=cfg, depth=depth, damping=mixing_damping, decay=damping_decay)
    if schedule is not None:
        round_fn = cached_jit(
            cache, ("c2dfb/schedule",) + ckey,
            lambda: _built("c2dfb_round", lambda st, gen, Wt, ay, az, hs: c2dfb_schedule_round(
                st, gen, Wt, ay, az, hs, **body_kw)),
        )
    else:
        round_fn = cached_jit(
            cache, ("c2dfb/masked",) + ckey,
            lambda: _built("c2dfb_round", lambda st, gen, ay, az: c2dfb_masked_round(st, gen, ay, az, **body_kw)),
        )

    cost = mem0 = None
    fleet_oracles = {k: v * topo.m for k, v in c2dfb_oracle_calls(cfg).items()}
    rows: list[dict] = []
    for t in range(T):
        w0 = obs.hostspans.now() if obs is not None else 0.0
        active_t = plan.masks[t] if plan.masks is not None else None
        act_edges = tuple((i, j) for i, j in edges if active_t[i, j]) if active_t is not None else edges
        if const_bytes is not None:
            bytes_y = bytes_z = const_bytes
        else:
            # honest per-node packet sizes: serialize CURRENT residuals
            bd, bs = inner_message_bytes(state.inner_y, comp, generator)
            bytes_y = np.asarray(bd) + np.asarray(bs)
            bd, bs = inner_message_bytes(state.inner_z, comp, generator)
            bytes_z = np.asarray(bd) + np.asarray(bs)

        rt = scheduler.drive_round(
            t, cfg.K, bytes_y, bytes_z, outer_node_bytes, compute_step,
            active=active_t, catchup_bytes=plan.catchup_bytes, track_lag=plan.track_lag,
        )
        tl_y, tl_z = rt.tl_y, rt.tl_z
        args = (tl_y.ages, tl_z.ages) if schedule is None else (plan.Ws[t], tl_y.ages, tl_z.ages, hists)
        if obs is not None and t == 0:
            with obs.span("cost_analysis", engine="async-eager"):
                out, cost = async_round_cost(
                    problem, topo, cfg, plan, mixing_damping, damping_decay, state, generator, round_fn,
                    *args,
                )
            mem0 = memory_peak_bytes(device)
        else:
            out = round_fn(state, generator, *args)
        if schedule is not None:
            state, mets, hists = out
        else:
            state, mets = out

        ledger.record_loop(t, "y", tl_y.ages, tl_y.start_s(rt.x_end), tl_y.end_s, edges=act_edges)
        ledger.record_loop(t, "z", tl_z.ages, tl_z.start_s(tl_y.end_s), tl_z.end_s, edges=act_edges)
        x_err = float(mets["x_consensus_err"])
        ledger.record_point(rt.t_end, x_err)

        edge_ages = edge_age_samples((tl_y.ages, tl_z.ages), act_edges)
        row = dict(mets)
        row["sim_seconds"] = np.float64(rt.t_end - rt.t_start)
        row["wire_bytes"] = np.int64(tl_y.wire_bytes + tl_z.wire_bytes + rt.outer_wire_bytes)
        smax, smean, shist = staleness_stats(edge_ages, depth)
        row["staleness_max"] = smax
        row["staleness_mean"] = smean
        row["staleness_hist"] = shist
        rows.append(row)
        if obs is not None:
            w1 = obs.hostspans.now()
            obs.hostspans.add(f"round[{t}]", w0, w1)
            obs.round(
                "async-eager", t, row,
                bytes_by_stream=rt.wire_bytes_by_stream,
                wall_seconds=w1 - w0, trace_counts=trace_counts(),
                oracle_calls=fleet_oracles,
                compute_flops=cost.flops,
                hbm_bytes=cost.hbm_bytes,
                compile_seconds=None,
                memory_peak_bytes=mem0 if t == 0 else None,
            )
            # node rows: per-sender egress from the scheduler's accounting,
            # per-node consensus distance from the round body, per-node
            # staleness over each node's incident in-edges
            node_wire = rt.node_wire_bytes
            nmax, nmean = node_staleness_stats((tl_y.ages, tl_z.ages), act_edges, topo.m)
            x_nd = mets["x_node_dist"].detach().cpu().numpy()
            for i in range(topo.m):
                obs.node(
                    "async-eager", t, i,
                    {
                        "x_dist": x_nd[i],
                        "wire_bytes": node_wire[i],
                        "staleness_max": nmax[i],
                        "staleness_mean": nmean[i],
                        "compute_flops": cost.flops / topo.m,
                    },
                    bytes_by_stream=rt.node_bytes_by_stream(i),
                )

    metrics = _stack_rows(rows)
    metrics["ledger"] = ledger
    return state, metrics


# ---------------------------------------------------------------------------
# baselines under the same scheduler (delayed VALUE gossip: no reference
# points — each step transmits the dense iterate, staleness delays it)
# ---------------------------------------------------------------------------


def delayed_value_scan(
    value: Tree,
    W: torch.Tensor,
    gamma: float,
    ages: torch.Tensor,
    depth: int,
    local_update,
    damping: str = "none",
    decay: float = 0.5,
) -> Tree:
    """Staleness-gated twin of `repro_torch.core.baselines.value_gossip_scan`:
    one step per entry of ``ages`` ((steps, m, m) integer tensor on the
    value's device) of  v <- local_update(v + gamma * mix(views), v_pre)
    where the views are age-gated versions of the transmitted iterate.
    ``local_update`` has the same (mixed, pre) contract as the synchronous
    scan; ``damping`` the C2DFB engine's weight policies."""
    hist = init_history(value, depth)
    for k in range(ages.shape[0]):
        delta = mix_delta_delayed(W, hist, ages[k], damping, decay)
        mixed = tree_map(lambda a, d_: a + gamma * d_, value, delta)
        v_new = local_update(mixed, value)
        hist = push_history(hist, v_new)
        value = v_new
    return value


def _baseline_round(alg, state, problem, topo, cfg, ages, depth, delayed, damping, decay):
    if alg == "madsbo":
        return madsbo_round_async(state, problem, topo, cfg, ages[0], ages[1], depth, delayed, damping, decay)
    return mdbo_round_async(state, problem, topo, cfg, ages[0], depth, delayed, damping, decay)


def baseline_masked_round(
    alg: str,
    state,
    ages_ll: np.ndarray,
    ages_h: np.ndarray | None = None,
    *,
    problem: BilevelProblem,
    topo: Topology,
    cfg,
    depth: int,
    damping: str = "none",
    decay: float = 0.5,
) -> tuple:
    """The baselines' single age-masked round body (MADSBO / MDBO twin of
    `c2dfb_masked_round`): a branch on the host ages keeps zero-age rounds
    bit-identical to the synchronous value-gossip scans."""
    ages = (ages_ll, ages_h) if alg == "madsbo" else (ages_ll,)
    if not _stale(*ages):
        return _baseline_round(alg, state, problem, topo, cfg, [None] * len(ages), depth, False, "none", 0.5)
    return _baseline_round(alg, state, problem, topo, cfg, [_on(a, state.x) for a in ages], depth, True, damping, decay)


@dataclasses.dataclass(frozen=True)
class BaselineRoundTimeline:
    """One baseline round's scheduler execution (``tl_h`` is None for MDBO,
    whose Neumann terms are local compute).  ``outer_wire_bytes`` is the
    upper-level barrier's dense traffic; ``outer_node_wire_bytes`` its
    per-sender split.  Under ``version_rule="acked"`` the loops' ack
    traffic is reported as a separate ``ack`` stream (key present only
    when nonzero — same convention as `RoundTimeline`)."""

    tl_ll: object
    tl_h: object | None
    t_start: float
    t_end: float
    outer_wire_bytes: int = 0
    outer_node_wire_bytes: np.ndarray | None = None

    @property
    def wire_bytes_by_stream(self) -> dict[str, int]:
        ack = int(self.tl_ll.ack_wire_bytes)
        by = {
            "outer": int(self.outer_wire_bytes),
            "ll": int(self.tl_ll.wire_bytes) - int(self.tl_ll.ack_wire_bytes),
        }
        if self.tl_h is not None:
            ack += int(self.tl_h.ack_wire_bytes)
            by["higp"] = int(self.tl_h.wire_bytes) - int(self.tl_h.ack_wire_bytes)
        if ack:
            by["ack"] = ack
        return by

    @property
    def wire_bytes(self) -> int:
        return sum(self.wire_bytes_by_stream.values())

    @property
    def node_wire_bytes(self) -> np.ndarray | None:
        """(m,) per-sender egress over the whole round (upper-level barrier
        + value-gossip loops, acks included); sums to ``wire_bytes``."""
        parts = [self.outer_node_wire_bytes, self.tl_ll.node_wire_bytes]
        if self.tl_h is not None:
            parts.append(self.tl_h.node_wire_bytes)
        if any(p is None for p in parts):
            return None
        return np.sum(parts, axis=0)

    def node_bytes_by_stream(self, i: int) -> dict[str, int] | None:
        """Node ``i``'s egress split by stream."""
        if self.node_wire_bytes is None:
            return None

        def _ack(tl) -> int:
            a = tl.node_ack_wire_bytes
            return int(a[i]) if a is not None else 0

        ack = _ack(self.tl_ll)
        by = {
            "outer": int(self.outer_node_wire_bytes[i]),
            "ll": int(self.tl_ll.node_wire_bytes[i]) - _ack(self.tl_ll),
        }
        if self.tl_h is not None:
            ack += _ack(self.tl_h)
            by["higp"] = int(self.tl_h.node_wire_bytes[i]) - _ack(self.tl_h)
        if ack:
            by["ack"] = ack
        return by


def drive_baseline_round(
    scheduler: AsyncScheduler,
    alg: str,
    round_idx: int,
    K: int,
    Q: int,
    N: int,
    dy_bytes: int,
    dx_bytes: int,
    compute_step: float,
) -> BaselineRoundTimeline:
    """One MADSBO/MDBO round's scheduler timeline: the LL value-gossip
    loop (plus MADSBO's HIGP loop), the drain, and the upper-level barrier.
    MDBO's Neumann terms are local compute (no gossip in this realization)
    and ride the barrier phase's compute slice."""
    t_start = float(scheduler.clock.max())
    tl_ll = scheduler.run_loop(K, dy_bytes, round_idx, compute_step, loop="ll")
    tl_h = None
    if alg == "madsbo":
        tl_h = scheduler.run_loop(Q, dy_bytes, round_idx, compute_step, loop="higp")
    scheduler.drain(tl_h.end_s if tl_h is not None else tl_ll.end_s)
    t_end = scheduler.barrier_phase(dx_bytes, round_idx, compute_s=compute_step * (1 + N), label="ul")
    outer_node_wire = np.asarray(
        [int(dx_bytes) * len(v) for v in scheduler.fabric.topo.neighbors], dtype=np.int64
    )
    return BaselineRoundTimeline(
        tl_ll=tl_ll, tl_h=tl_h, t_start=t_start, t_end=t_end,
        outer_wire_bytes=int(outer_node_wire.sum()),
        outer_node_wire_bytes=outer_node_wire,
    )


def run_baseline_async(
    alg: str,
    problem: BilevelProblem,
    topo: Topology,
    cfg,
    x0: Tree,
    y0: Tree,
    T: int,
    fabric,
    policy: str = "bounded",
    bound: int = 2,
    version_rule: str = "common",
    ledger: StalenessLedger | None = None,
    mixing_damping: str = "none",
    damping_decay: float = 0.5,
    compiled: bool = False,
    fn_cache: dict | None = None,
    obs=None,
    device: str | torch.device | None = None,
) -> tuple[object, dict]:
    """MADSBO / MDBO rounds driven by the AsyncScheduler: their dense
    value-gossip loops run event-driven with age-gated mixing; the
    hypergradient assembly and upper-level update stay at the (barrier)
    round boundary, mirroring the sync baselines.  ``mixing_damping`` and
    ``version_rule`` as in `run_async`.  ``compiled=True`` (the compiled
    runtime) is not ported yet and raises.  Metrics: the round body's
    tensors stacked over rounds, host ``sim_seconds`` and ``wire_bytes``,
    and the ``ledger``."""
    if alg not in ("madsbo", "mdbo"):
        raise ValueError(f"unknown async baseline {alg!r}")
    validate_damping(mixing_damping)
    if compiled:
        raise ValueError(COMPILED_NOT_PORTED)
    obs = as_obs(obs)
    device = run_device(problem, x0, y0, device)
    transport = as_transport(fabric).bind(topo)
    fabric = transport.fabric
    scheduler = AsyncScheduler(transport, policy=policy, bound=bound, version_rule=version_rule)
    ledger = ledger if ledger is not None else StalenessLedger()
    dy_bytes = _dense_node_bytes(y0)
    dx_bytes = _dense_node_bytes(x0)
    K = cfg.K
    Q = getattr(cfg, "Q", 0)            # MADSBO's HIGP subsolver steps
    N = getattr(cfg, "neumann_N", 0)    # MDBO's local Neumann terms
    n_units = K + Q + N + 1
    compute_step = fabric.compute_s / n_units if fabric.compute_s else 0.0
    depth = scheduler.depth_for(max(K, Q))

    state = madsbo_init(problem, x0, y0) if alg == "madsbo" else mdbo_init(x0, y0)
    cache = fn_cache if fn_cache is not None else {}
    round_fn = _baseline_round_fn(cache, alg, problem, topo, cfg, depth, mixing_damping, damping_decay)
    edges = edge_list(topo)

    cost = mem0 = None
    fleet_oracles = oracle_calls_for(alg, cfg, m=topo.m)
    rows = []
    for t in range(T):
        w0 = obs.hostspans.now() if obs is not None else 0.0
        rt = drive_baseline_round(scheduler, alg, t, K, Q, N, dy_bytes, dx_bytes, compute_step)
        tl_ll, tl_h = rt.tl_ll, rt.tl_h
        ages = (tl_ll.ages, tl_h.ages) if alg == "madsbo" else (tl_ll.ages,)
        if obs is not None and t == 0:
            with obs.span("cost_analysis", engine="baseline-eager"):
                (state, mets), cost = baseline_round_cost(
                    alg, problem, topo, cfg, depth, mixing_damping, damping_decay, state, *ages
                )
            mem0 = memory_peak_bytes(device)
        else:
            state, mets = round_fn(state, *ages)
        ledger.record_loop(t, "ll", tl_ll.ages, tl_ll.start_s(rt.t_start), tl_ll.end_s)
        if tl_h is not None:
            ledger.record_loop(t, "higp", tl_h.ages, tl_h.start_s(tl_ll.end_s), tl_h.end_s)
        x_err = float(mets["x_consensus_err"])
        ledger.record_point(rt.t_end, x_err)
        row = dict(mets)
        row["sim_seconds"] = np.float64(rt.t_end - rt.t_start)
        row["wire_bytes"] = np.int64(rt.wire_bytes)
        rows.append(row)
        if obs is not None:
            w1 = obs.hostspans.now()
            obs.hostspans.add(f"round[{t}]", w0, w1)
            obs.round(
                "baseline-eager", t, row,
                bytes_by_stream=rt.wire_bytes_by_stream,
                wall_seconds=w1 - w0, trace_counts=trace_counts(),
                oracle_calls=fleet_oracles,
                compute_flops=cost.flops,
                hbm_bytes=cost.hbm_bytes,
                compile_seconds=None,
                memory_peak_bytes=mem0 if t == 0 else None,
            )
            node_wire = rt.node_wire_bytes
            nmax, nmean = node_staleness_stats(ages, edges, topo.m)
            x_nd = mets["x_node_dist"].detach().cpu().numpy()
            for i in range(topo.m):
                obs.node(
                    "baseline-eager", t, i,
                    {
                        "x_dist": x_nd[i],
                        "wire_bytes": node_wire[i],
                        "staleness_max": nmax[i],
                        "staleness_mean": nmean[i],
                        "compute_flops": cost.flops / topo.m,
                    },
                    bytes_by_stream=rt.node_bytes_by_stream(i),
                )

    metrics = _stack_rows(rows)
    metrics["ledger"] = ledger
    return state, metrics


def _baseline_round_fn(cache: dict, alg: str, problem, topo, cfg, depth: int, damping: str, decay: float):
    """The baselines' masked round from the shared keyed cache (same helper
    the C2DFB paths use)."""
    ckey = ("baseline", alg, id(problem), id(topo), cfg, depth, damping, decay)
    kw = dict(problem=problem, topo=topo, cfg=cfg, depth=depth, damping=damping, decay=decay)
    return cached_jit(
        cache, ckey,
        lambda: _built(f"{alg}_round", lambda st, *ages: baseline_masked_round(alg, st, *ages, **kw)),
    )
