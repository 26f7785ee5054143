"""Compiled asynchronous runtime (``repro.async_gossip.compiled``'s
counterpart): a scheduler replay on the host, then the eager engine's round
bodies, on a card replayed from CUDA graphs.

The eager engine (`engine.run_async`) goes through the host every round: it
serializes the current residuals for packet sizes, steps the numpy scheduler
and dispatches the round's device work operator by operator from Python.
This module splits a run into three phases, as the reference does:

* **Phase 1 (host, once).**  Replay the `AsyncScheduler` for all T rounds up
  front (`AsyncScheduler.replay_rounds`) with ANALYTIC payload sizes
  (`engine.analytic_message_bytes`), plus the schedule's active-edge masks
  and re-entry catch-up packets: the (T, K, m, m) ages, each round's
  simulated seconds and wire bytes, byte for byte the scheduler calls (and
  draws) of T eager rounds fed the same sizes.  The ages also fix each
  round's branch: the synchronous round where all its ages are zero, the
  delayed round otherwise.

* **Phase 2 (device).**  Run the T rounds of the round bodies the eager
  engine runs (`engine.async_c2dfb_round`, the baselines'
  `madsbo_round_async` / `mdbo_round_async`) from the precomputed ages
  (`RoundGraphs.run`).  On the CPU this is a loop over the built bodies.  On
  a card each branch's first round runs eagerly on the capturing stream (it
  builds and loads the kernels, traces the oracles, gives cuBLAS its
  workspace); if the branch comes again, its body is then captured ONCE in a
  CUDA graph and every later round of the branch replays it: the counterpart
  of the reference's one ``lax.scan`` compilation, whatever T is.  The
  carry lives in static buffers that the graph writes back; round t's ages
  (and schedule matrix) reach the graph's static input slots by a
  device-to-device copy from stacks uploaded once; each round's metrics are
  copied into (T, ...) stacks on the device.  Nothing in the replay loop
  reads the device from the host (heartbeats aside).

* **Phase 3 (host).**  The ledger, the staleness rows, the simulated
  seconds and the wire bytes come from the replayed timelines
  (`StalenessLedger.record_replay`, `replay_staleness_rows`); with ``obs``
  the round and node records are emitted after the run, and
  ``Obs(heartbeat_every=N)`` beats between rounds while it runs.

The math is the eager engine's: `run_async(payload_bytes="analytic")` on the
same inputs gives the same state, metrics and ledger bit for bit.  What the
compiled path trades is byte accuracy in the timing model only: every round
is priced at the steady-state packet size instead of its measured residuals.

Graph captures are counted apart from the build counters (`graph_captures`):
``trace_counts()`` stays the reference's (one ``compiled_scan`` and one round
body a run), while a card run captures at most one graph a branch.  On a card
the run's random source must be a ``torch.Generator`` on the card: each graph
registers it, so a replay draws what the eager round would draw; a host draw
source raises.  A capture or a replay that fails raises: no round falls back
to eager execution, and none to the CPU.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from repro_torch.async_gossip.engine import (
    _dense_node_bytes,
    _prepare_async_run,
    _stale,
    _built,
    analytic_message_bytes,
    async_c2dfb_round,
    async_round_cost,
    baseline_round_cost,
    cached_jit,
    drive_baseline_round,
    record_trace,
    trace_counts,
)
from repro_torch.async_gossip.ledger import StalenessLedger, node_staleness_stats, replay_staleness_rows
from repro_torch.async_gossip.mixing import validate_damping
from repro_torch.async_gossip.scheduler import AsyncScheduler
from repro_torch.core.baselines import madsbo_init, madsbo_round_async, mdbo_init, mdbo_round_async
from repro_torch.core.bilevel_problem import BilevelProblem
from repro_torch.core.c2dfb import C2DFBConfig, C2DFBState, _mixing_matrix, init_state, run_device
from repro_torch.core.topology import Topology
from repro_torch.core.types import Tree, donate_copy
from repro_torch.net.fabric import edge_list
from repro_torch.obs.compute import c2dfb_oracle_calls, memory_peak_bytes, oracle_calls_for
from repro_torch.obs.core import as_obs, scan_heartbeat
from repro_torch.transport.base import as_transport

#: graph captures by round body and branch ("c2dfb/sync", "mdbo/delayed", ...)
_GRAPH_CAPTURES: collections.Counter = collections.Counter()


def graph_captures() -> dict[str, int]:
    """Snapshot of the CUDA graph captures, by round body and branch."""
    return dict(_GRAPH_CAPTURES)


def reset_graph_captures() -> None:
    _GRAPH_CAPTURES.clear()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a carry (tensors, dicts in sorted-key order, tuples and
    named tuples), in order; other leaves (a round counter) are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _tensors(x)]
    return []


def _rebuild(like, tensors: list[torch.Tensor]):
    """``like`` with its tensors replaced, in `_tensors` order."""
    it = iter(tensors)

    def go(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(go(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return t

    return go(like)


def _write_back(static: list[torch.Tensor], outs: list[torch.Tensor]) -> None:
    """Copy a round's output carry into the static carry.  An output that
    is a static buffer of ANOTHER slot is copied out first, so no slot reads
    a buffer that an earlier slot's copy has overwritten."""
    held = {v.untyped_storage().data_ptr() for v in static}
    outs = [o.clone() if o is not s and o.untyped_storage().data_ptr() in held else o for o, s in zip(outs, static)]
    for s, o in zip(static, outs):
        if o is not s:
            s.copy_(o)


class RoundGraphs:
    """A compiled run's round bodies (``bodies``: branch -> ``body(carry,
    generator, slots) -> (carry, metrics)``, where ``slots`` maps a name to
    the round's slice of the stacked device inputs) and, on a card, what
    replays them: each branch's CUDA graph and its static metric outputs,
    one memory pool the graphs share, the capturing stream, the static
    carry and the static input slots.  Cached under ``fn_cache`` with
    everything it holds, so a warm run replays the graphs of an earlier
    one; the carry and the metrics a run returns are fresh tensors, never
    these buffers."""

    def __init__(self, name: str, bodies: dict, problem: BilevelProblem):
        self.name, self.bodies, self.problem = name, bodies, problem
        self.graphs: dict = {}  # branch -> (CUDAGraph, static metric outputs)
        self.generator = None   # the source the graphs registered
        self.stream = self.pool = None
        self.carry: list[torch.Tensor] | None = None
        self.slots: dict[str, torch.Tensor] | None = None

    def run(self, carry, xs: dict, branches: list[str], generator=None, first=None, on_round=None):
        """Run ``len(branches)`` rounds from ``carry``: round t takes branch
        ``branches[t]`` and the slices ``xs[name][t]`` of the stacked device
        inputs.  ``first(body, carry, generator, slots)`` runs round 0 in
        place of ``body(carry, generator, slots)`` (the cost meter);
        ``on_round(t, metrics)`` is called after each round.  Returns the
        final carry and the metrics stacked over rounds, on the carry's
        device."""
        if not _tensors(carry)[0].is_cuda:
            return self._run_host(carry, xs, branches, generator, first, on_round)
        return self._run_card(carry, xs, branches, generator, first, on_round)

    def _run_host(self, carry, xs, branches, generator, first, on_round):
        rows = []
        for t, br in enumerate(branches):
            slots = {k: v[t] for k, v in xs.items()}
            body = self.bodies[br]
            if t == 0 and first is not None:
                carry, mets = first(body, carry, generator, slots)
            else:
                carry, mets = body(carry, generator, slots)
            rows.append(mets)
            if on_round is not None:
                on_round(t, mets)
        return carry, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def _run_card(self, carry, xs, branches, generator, first, on_round):
        leaves = _tensors(carry)
        if self.stream is None:
            self.stream = torch.cuda.Stream(leaves[0].device)
            self.pool = torch.cuda.graph_pool_handle()
        if generator is not self.generator:  # the graphs drew from another source
            self.graphs.clear()
            self.generator = generator
        caller = torch.cuda.current_stream(leaves[0].device)
        self.stream.wait_stream(caller)
        T = len(branches)
        left = collections.Counter(branches)
        with torch.cuda.stream(self.stream):
            if self.carry is None:
                self.carry = donate_copy(leaves)
                self.slots = {k: torch.empty_like(v[0]) for k, v in xs.items()}
            else:
                for s, v in zip(self.carry, leaves):
                    s.copy_(v)
            static = _rebuild(carry, self.carry)
            stacks = None
            for t, br in enumerate(branches):
                left[br] -= 1
                for k, v in xs.items():
                    self.slots[k].copy_(v[t])
                if br in self.graphs and not (t == 0 and first is not None):
                    graph, mets = self.graphs[br]
                    graph.replay()
                else:  # a branch's first round (and a counted round 0) runs eagerly
                    body = self.bodies[br]
                    if t == 0 and first is not None:
                        out, mets = first(body, static, generator, self.slots)
                    else:
                        out, mets = body(static, generator, self.slots)
                    _write_back(self.carry, _tensors(out))
                    if left[br] and br not in self.graphs:
                        self.graphs[br] = self._capture(br, static, generator)
                if stacks is None:
                    stacks = {k: torch.empty((T,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                              for k, v in mets.items()}
                for k, v in mets.items():
                    stacks[k][t].copy_(v)
                if on_round is not None:
                    on_round(t, {k: v[t] for k, v in stacks.items()})
            final = [v.clone() for v in self.carry]
            # allocated on the capturing stream, handed to the caller's
            for v in final + list(stacks.values()):
                v.record_stream(caller)
        caller.wait_stream(self.stream)
        return _rebuild(carry, final), stacks

    def _capture(self, br: str, static, generator):
        """Capture branch ``br``'s body on the static carry and slots, with
        the write-back of its carry; returns the graph and its static metric
        outputs."""
        graph = torch.cuda.CUDAGraph()
        if isinstance(generator, torch.Generator):
            graph.register_generator_state(generator)
        # the oracle memo is keyed on x's tensors: the graph must compute
        # the x-only values from the x it holds, not read an earlier round's
        self.problem.graphs.forget()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out, mets = self.bodies[br](static, generator, self.slots)
            _write_back(self.carry, _tensors(out))
        self.problem.graphs.forget()
        _GRAPH_CAPTURES[f"{self.name}/{br}"] += 1
        return graph, mets


def _check_source(generator, device: torch.device) -> None:
    """On a card the draws run inside captured graphs, which replay a
    ``torch.Generator`` on the card (registered with each graph) and
    nothing else: a host source's draws would be captured as the samples of
    one round and replayed on every later one."""
    if device.type != "cuda" or generator is None:
        return
    if not isinstance(generator, torch.Generator) or generator.device.type != "cuda":
        raise ValueError(
            "compiled=True on a CUDA device replays captured CUDA graphs, which draw only from a "
            f"torch.Generator on the card; got {type(generator).__name__} "
            f"{getattr(generator, 'device', '')}: pass torch.Generator(device='cuda'), or run the eager engine"
        )


def _device_stack(arrays: list, device) -> torch.Tensor:
    return torch.as_tensor(np.stack(arrays).astype(np.int32), device=device)


@contextlib.contextmanager
def _null_span(name, engine=None):
    """Span stand-in when no ``obs`` handle is attached."""
    yield


def _hb_key(obs) -> tuple:
    return obs.heartbeat_cache_key() if obs is not None else ("hb", 0)


ENGINE = "async-compiled"
BASELINE_ENGINE = "baseline-compiled"


def run_async_compiled(
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
    fn_cache: dict | None = None,
    donate: bool = True,
    obs=None,
    device: str | torch.device | None = None,
) -> tuple[C2DFBState, dict]:
    """T outer rounds of C2DFB from a scheduler replay: `run_async`'s
    signature and metric contract (keys, dtypes, ledger), reached through
    ``c2dfb.run(async_mode=..., compiled=True)``.

    Payload sizes are always analytic (no round's timeline may depend on
    the round math).  ``version_rule`` is carried by the replay, so the
    compiled run equals the eager engine's under every rule, acked pricing
    included.  ``fabric`` may be a `Transport` (`SimTransport`).
    ``fn_cache`` shares the built round bodies, and on a card their graphs,
    across runs (`engine.cached_jit`).  The caller's x0/y0 are never
    written: on a card the carry is copied into the graphs' static buffers,
    and on the CPU ``donate=True`` copies it first (`donate_copy`), as the
    reference donates a fresh copy.

    ``obs`` streams the eager engine's records, emitted after the run:
    spans ``replay``, ``cost_analysis`` (round 0, counted as in the eager
    engine) and ``scan`` (``compile+scan`` when the bodies were built in
    this run).  ``Obs(heartbeat_every=N)`` emits a heartbeat every N rounds
    between rounds, the only host reads of the loop; the cache key holds
    the heartbeat handle, as the reference's does."""
    obs = as_obs(obs)
    validate_damping(mixing_damping)
    device = run_device(problem, x0, y0, device)
    _check_source(generator, device)
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
    msg_bytes = analytic_message_bytes(state.inner_y, comp)
    span = obs.span if obs is not None else _null_span

    # ---- phase 1: host timeline replay --------------------------------
    with span("replay", engine=ENGINE):
        rounds = scheduler.replay_rounds(
            T, cfg.K, msg_bytes, msg_bytes, outer_node_bytes, compute_step,
            masks=plan.masks, catchup_bytes=plan.catchup_bytes, track_lag=plan.track_lag,
        )
    if not rounds:
        return state, {"ledger": ledger}
    ages_y = [rt.tl_y.ages for rt in rounds]
    ages_z = [rt.tl_z.ages for rt in rounds]
    xs = {"ages_y": _device_stack(ages_y, device), "ages_z": _device_stack(ages_z, device)}
    body_kw = dict(damping=mixing_damping, decay=damping_decay)
    if schedule is None:
        kind, carry = "c2dfb", state
        branches = ["delayed" if _stale(a, b) else "sync" for a, b in zip(ages_y, ages_z)]

        def build():
            record_trace("compiled_scan")
            W = _mixing_matrix(topo, state.x)  # uploaded once; the graphs read it

            def sync(st, gen, slots):
                return async_c2dfb_round(st, gen, problem, topo, cfg, None, None, plan.depth, delayed=False, W=W)

            def delayed(st, gen, slots):
                return async_c2dfb_round(st, gen, problem, topo, cfg, slots["ages_y"], slots["ages_z"],
                                         plan.depth, delayed=True, W=W, **body_kw)

            return RoundGraphs(kind, _built("c2dfb_round", {"sync": sync, "delayed": delayed}), problem)
    else:
        kind, carry = "c2dfb-schedule", (state, plan.hists)
        branches = ["delayed"] * T
        xs["W"] = torch.as_tensor(plan.Ws, dtype=torch.float32, device=device)

        def build():
            record_trace("compiled_scan")

            def delayed(c, gen, slots):
                st, mets, hs = async_c2dfb_round(c[0], gen, problem, topo, cfg, slots["ages_y"], slots["ages_z"],
                                                 plan.depth, delayed=True, W=slots["W"], hists=c[1], **body_kw)
                return (st, hs), mets

            return RoundGraphs(kind, _built("c2dfb_round", {"delayed": delayed}), problem)

    cost = mem0 = None
    fleet_oracles = {k: v * topo.m for k, v in c2dfb_oracle_calls(cfg).items()}

    def first(body, c, gen, slots):
        """Round 0 under the counters (`async_round_cost`), as in the eager
        engine; the run's own round, no extra one."""
        nonlocal cost, mem0
        with obs.span("cost_analysis", engine=ENGINE):
            out, cost = async_round_cost(
                problem, topo, cfg, plan, mixing_damping, damping_decay, c, gen,
                lambda st, g: body(st, g, slots), took_delayed=branches[0] == "delayed",
            )
        mem0 = memory_peak_bytes(device)
        return out

    # ---- phase 2: the rounds, replayed ---------------------------------
    cache = fn_cache if fn_cache is not None else {}
    ckey = (kind + "/compiled", id(problem), id(topo), cfg, plan.depth, mixing_damping, damping_decay,
            donate) + _hb_key(obs)
    label = "scan" if ckey in cache else "compile+scan"
    runner = cached_jit(cache, ckey, build)
    if donate and device.type == "cpu":
        carry = donate_copy(carry)
    hb = obs is not None and obs.heartbeat_on
    with span(label, engine=ENGINE):
        carry, mets = runner.run(
            carry, xs, branches, generator, first=first if obs is not None else None,
            on_round=(lambda t, m: scan_heartbeat(obs, ENGINE, t, m)) if hb else None,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    state = (carry if schedule is None else carry[0])._replace(t=state.t + T)

    # ---- phase 3: metrics and ledger from the stacked replay ----------
    metrics = dict(mets)
    if plan.masks is not None:
        edges_per_round = [tuple((i, j) for i, j in edges if plan.masks[t][i, j]) for t in range(T)]
    else:
        edges_per_round = [edges] * T
    ledger.record_replay(rounds, mets["x_consensus_err"].detach().cpu().numpy().astype(np.float64),
                         edges_per_round)
    metrics["sim_seconds"] = np.asarray([rt.t_end - rt.t_start for rt in rounds], np.float64)
    metrics["wire_bytes"] = np.asarray(
        [rt.tl_y.wire_bytes + rt.tl_z.wire_bytes + rt.outer_wire_bytes for rt in rounds], np.int64
    )
    smax, smean, shist = replay_staleness_rows(rounds, edges_per_round, plan.depth)
    metrics["staleness_max"] = smax
    metrics["staleness_mean"] = smean
    metrics["staleness_hist"] = shist
    metrics["ledger"] = ledger
    if obs is not None:
        _emit_records(obs, ENGINE, metrics, rounds, topo, cost, mem0, fleet_oracles,
                      lambda t, rt: ((rt.tl_y.ages, rt.tl_z.ages), edges_per_round[t]))
    return state, metrics


def _emit_records(obs, engine, metrics, rounds, topo, cost, mem0, fleet_oracles, node_ages) -> None:
    """The round and node records of a compiled run, after it: the eager
    engines' records, with the replayed timelines' bytes and staleness.
    ``node_ages(t, rt)`` gives round t's (age arrays, edges) for the node
    rows' staleness."""
    tc = trace_counts()
    host = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in metrics.items() if k != "ledger"}
    for t, rt in enumerate(rounds):
        obs.round(
            engine, t, {k: v[t] for k, v in host.items()},
            bytes_by_stream=rt.wire_bytes_by_stream,
            trace_counts=tc,
            oracle_calls=fleet_oracles,
            compute_flops=cost.flops,
            hbm_bytes=cost.hbm_bytes,
            compile_seconds=cost.compile_seconds if t == 0 else None,
            memory_peak_bytes=mem0 if t == 0 else None,
        )
        node_wire = rt.node_wire_bytes
        nmax, nmean = node_staleness_stats(*node_ages(t, rt), topo.m)
        for i in range(topo.m):
            obs.node(
                engine, t, i,
                {
                    "x_dist": host["x_node_dist"][t, i],
                    "wire_bytes": node_wire[i],
                    "staleness_max": nmax[i],
                    "staleness_mean": nmean[i],
                    "compute_flops": cost.flops / topo.m,
                },
                bytes_by_stream=rt.node_bytes_by_stream(i),
            )


def run_baseline_async_compiled(
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
    fn_cache: dict | None = None,
    donate: bool = True,
    obs=None,
    device: str | torch.device | None = None,
) -> tuple[object, dict]:
    """MADSBO / MDBO under the async scheduler from a scheduler replay
    (reached through ``run_baseline_async(..., compiled=True)``).  Baseline
    packets are dense iterates, whose sizes were analytic already, so the
    run equals the eager baseline loop in its trajectory AND its bytes.
    ``obs``, ``fn_cache`` and ``donate`` as in `run_async_compiled`."""
    if alg not in ("madsbo", "mdbo"):
        raise ValueError(f"unknown async baseline {alg!r}")
    obs = as_obs(obs)
    validate_damping(mixing_damping)
    device = run_device(problem, x0, y0, device)
    transport = as_transport(fabric).bind(topo)
    fabric = transport.fabric
    scheduler = AsyncScheduler(transport, policy=policy, bound=bound, version_rule=version_rule)
    ledger = ledger if ledger is not None else StalenessLedger()
    dy_bytes = _dense_node_bytes(y0)
    dx_bytes = _dense_node_bytes(x0)
    K = cfg.K
    Q = getattr(cfg, "Q", 0)
    N = getattr(cfg, "neumann_N", 0)
    compute_step = fabric.compute_s / (K + Q + N + 1) if fabric.compute_s else 0.0
    depth = scheduler.depth_for(max(K, Q))
    state = madsbo_init(problem, x0, y0) if alg == "madsbo" else mdbo_init(x0, y0)
    span = obs.span if obs is not None else _null_span

    # ---- phase 1: host timeline replay --------------------------------
    with span("replay", engine=BASELINE_ENGINE):
        rounds = [drive_baseline_round(scheduler, alg, t, K, Q, N, dy_bytes, dx_bytes, compute_step)
                  for t in range(T)]
    if not rounds:
        return state, {"ledger": ledger}
    host_ages = [(rt.tl_ll.ages, rt.tl_h.ages) if alg == "madsbo" else (rt.tl_ll.ages,) for rt in rounds]
    xs = {"ages_ll": _device_stack([a[0] for a in host_ages], device)}
    if alg == "madsbo":
        xs["ages_h"] = _device_stack([a[1] for a in host_ages], device)
    branches = ["delayed" if _stale(*a) else "sync" for a in host_ages]
    round_async = madsbo_round_async if alg == "madsbo" else mdbo_round_async

    def ages_of(slots):
        return (slots["ages_ll"], slots["ages_h"]) if alg == "madsbo" else (slots["ages_ll"],)

    def build():
        record_trace("compiled_scan")
        W = _mixing_matrix(topo, state.x)

        def sync(st, gen, slots):
            return round_async(st, problem, topo, cfg, *[None] * len(xs), depth, False, "none", 0.5, W=W)

        def delayed(st, gen, slots):
            return round_async(st, problem, topo, cfg, *ages_of(slots), depth, True, mixing_damping,
                               damping_decay, W=W)

        return RoundGraphs(alg, _built(f"{alg}_round", {"sync": sync, "delayed": delayed}), problem)

    cost = mem0 = None
    fleet_oracles = oracle_calls_for(alg, cfg, m=topo.m)

    def first(body, st, gen, slots):
        nonlocal cost, mem0
        with obs.span("cost_analysis", engine=BASELINE_ENGINE):
            out, cost = baseline_round_cost(alg, problem, topo, cfg, depth, mixing_damping, damping_decay, st,
                                            *host_ages[0], body=lambda s: body(s, gen, slots))
        mem0 = memory_peak_bytes(device)
        return out

    # ---- phase 2: the rounds, replayed ---------------------------------
    cache = fn_cache if fn_cache is not None else {}
    ckey = ("baseline/compiled", alg, id(problem), id(topo), cfg, depth, mixing_damping, damping_decay,
            donate) + _hb_key(obs)
    label = "scan" if ckey in cache else "compile+scan"
    runner = cached_jit(cache, ckey, build)
    carry = donate_copy(state) if donate and device.type == "cpu" else state
    hb = obs is not None and obs.heartbeat_on
    with span(label, engine=BASELINE_ENGINE):
        carry, mets = runner.run(
            carry, xs, branches, None, first=first if obs is not None else None,
            on_round=(lambda t, m: scan_heartbeat(obs, BASELINE_ENGINE, t, m)) if hb else None,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    state = carry._replace(t=state.t + T)

    # ---- phase 3: ledger and metrics from the replay -------------------
    metrics = dict(mets)
    x_errs = mets["x_consensus_err"].detach().cpu().numpy().astype(np.float64)
    for t, rt in enumerate(rounds):
        ledger.record_loop(t, "ll", rt.tl_ll.ages, rt.tl_ll.start_s(rt.t_start), rt.tl_ll.end_s)
        if rt.tl_h is not None:
            ledger.record_loop(t, "higp", rt.tl_h.ages, rt.tl_h.start_s(rt.tl_ll.end_s), rt.tl_h.end_s)
        ledger.record_point(rt.t_end, float(x_errs[t]))
    metrics["sim_seconds"] = np.asarray([rt.t_end - rt.t_start for rt in rounds], np.float64)
    metrics["wire_bytes"] = np.asarray([rt.wire_bytes for rt in rounds], np.int64)
    metrics["ledger"] = ledger
    if obs is not None:
        edges = edge_list(topo)
        _emit_records(obs, BASELINE_ENGINE, metrics, rounds, topo, cost, mem0, fleet_oracles,
                      lambda t, rt: (host_ages[t], edges))
    return state, metrics
