"""Algorithm 1 — C2DFB outer loop (``repro.core.c2dfb``'s synchronous path).

Per outer round t (per node i, node-stacked here):

    x^{t+1}   = x^t + gamma_out * sum_j w_ij (x_j - x_i) - eta_out * (s_x)^t
    y^{t+1}   = IN(h(x^{t+1}, .), y/refs/tracker state, K)      # h = f + lam*g
    z^{t+1}   = IN(g(x^{t+1}, .), z/refs/tracker state, K)
    u^{t+1}   = grad_x f(x,y) + lam * (grad_x g(x,y) - grad_x g(x,z))
    (s_x)^{t+1} = (s_x)^t + gamma_out * mix(s_x) + u^{t+1} - u^t

Outer communications (x and s_x) are uncompressed, matching the paper; all
inner-loop traffic is compressed residuals.  The round metrics carry the
exact wire bytes (``measured_bytes``), counted on the device.

``run`` is a Python loop over T rounds on one device (``cuda`` unless the
caller passes ``device="cpu"``).  Every entry point takes ``generator``,
the random source of a stochastic compressor (a ``torch.Generator`` on the
run's device, or a source object); draws follow the order written down in
`repro_torch.core.compression`, and deterministic compressors ignore it.
``run`` takes a topology ``schedule``, a network ``fabric`` (host numpy),
a telemetry handle ``obs`` and the asynchronous engine's arguments
(``async_mode`` and the rest, dispatched to
`repro_torch.async_gossip.engine.run_async`, or with ``compiled=True`` to
`repro_torch.async_gossip.compiled.run_async_compiled`), and a
``transport`` (`repro_torch.transport`: the simulated one, or the device
transport that executes every exchange).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bilevel_problem import BilevelProblem
from repro_torch.core.compression import Compressor, make_compressor
from repro_torch.core.gossip import mix_delta_dense
from repro_torch.core.inner_loop import (
    InnerState,
    inner_init,
    inner_loop,
    inner_message_bytes,
    inner_round_phases,
    inner_wire_bytes_per_round,
    pricing_face,
    refresh_tracker,
)
from repro_torch.core.topology import Topology
from repro_torch.core.types import (
    Tree,
    consensus_error,
    node_consensus_dist,
    node_mean,
    tree_count,
    tree_leaves,
    tree_map,
    tree_sq_norm,
)
from repro_torch.net.dynamic import validate_schedule_stack
from repro_torch.net.fabric import edge_list, edges_from_weights, mask_phases
from repro_torch.net.wire import codec_for
from repro_torch.obs.compute import c2dfb_oracle_calls, memory_peak_bytes, round_cost
from repro_torch.obs.core import as_obs, scan_heartbeat


@dataclasses.dataclass(frozen=True)
class C2DFBConfig:
    lam: float = 10.0
    eta_out: float = 0.5
    gamma_out: float = 0.5
    eta_in: float = 0.1
    gamma_in: float = 0.5
    K: int = 10
    compressor: str = "topk"
    comp_ratio: float = 0.2
    comp_bits: int = 4
    comp_block: int = 1024
    # Theorem 1 prescribes eta_in ~ 1/(kappa * lam * L_g) for the y-loop whose
    # objective h = f + lam*g is (1+lam)L-smooth.  eta_in is the z-loop
    # (plain g) step and the y-loop step is scaled by 1/(1+lam) so a single
    # knob stays stable across lambda; set scale_eta_y=False to disable.
    scale_eta_y: bool = True

    @property
    def eta_in_y(self) -> float:
        return self.eta_in / (1.0 + self.lam) if self.scale_eta_y else self.eta_in

    def make_compressor(self) -> Compressor:
        return make_compressor(
            self.compressor,
            ratio=self.comp_ratio,
            bits=self.comp_bits,
            block=self.comp_block,
        )


class C2DFBState(NamedTuple):
    x: Tree            # node-stacked UL models
    s_x: Tree          # node-stacked UL gradient trackers
    u_prev: Tree       # previous hypergradient estimates
    inner_y: InnerState
    inner_z: InnerState
    t: int


def init_state(problem: BilevelProblem, cfg: C2DFBConfig, x0: Tree, y0: Tree) -> C2DFBState:
    """x0/y0 are node-stacked initial points; z0 = y0 (Algorithm 1).  The
    state shares x0/y0's tensors; no step updates a tensor in place."""
    grad_h = problem.grad_y_h(cfg.lam)
    grad_g = problem.grad_y_g()
    inner_y = inner_init(y0, lambda d: grad_h(d, x0))
    inner_z = inner_init(y0, lambda d: grad_g(d, x0))
    u0 = problem.hyper_grad(x0, y0, y0, cfg.lam)
    return C2DFBState(x=x0, s_x=u0, u_prev=u0, inner_y=inner_y, inner_z=inner_z, t=0)


def _mixing_matrix(topo: Topology, like: Tree) -> torch.Tensor:
    return torch.as_tensor(topo.W, dtype=torch.float32, device=tree_leaves(like)[0].device)


def c2dfb_round_core(
    state: C2DFBState,
    generator,
    problem: BilevelProblem,
    W: torch.Tensor,
    cfg: C2DFBConfig,
    inner_fn,
) -> tuple[C2DFBState, dict]:
    """Shared outer-round body (Algorithm 1).  ``inner_fn(inner_state,
    generator, grad_fn, eta, tag)`` runs one K-step inner loop and returns
    ``(state, metrics)``; ``tag`` is "y" or "z"."""
    # ---- outer model update (uncompressed gossip + tracked descent) -------
    mix_x = mix_delta_dense(W, state.x)
    x_new = tree_map(
        lambda x, mx, s: x + cfg.gamma_out * mx - cfg.eta_out * s, state.x, mix_x, state.s_x
    )

    # ---- inner loops on the new x -----------------------------------------
    grad_h = problem.grad_y_h(cfg.lam)
    grad_g = problem.grad_y_g()
    gy = lambda d: grad_h(d, x_new)  # noqa: E731
    gz = lambda d: grad_g(d, x_new)  # noqa: E731

    inner_y = refresh_tracker(state.inner_y, gy)
    inner_z = refresh_tracker(state.inner_z, gz)
    inner_y, my = inner_fn(inner_y, generator, gy, cfg.eta_in_y, "y")
    inner_z, mz = inner_fn(inner_z, generator, gz, cfg.eta_in, "z")

    # ---- hypergradient + tracker update ------------------------------------
    u_new = problem.hyper_grad(x_new, inner_y.d, inner_z.d, cfg.lam)
    mix_s = mix_delta_dense(W, state.s_x)
    s_x_new = tree_map(
        lambda s, ms, un, up: s + cfg.gamma_out * ms + un - up,
        state.s_x, mix_s, u_new, state.u_prev,
    )

    new_state = C2DFBState(
        x=x_new, s_x=s_x_new, u_prev=u_new, inner_y=inner_y, inner_z=inner_z, t=state.t + 1
    )
    # exact per-round wire bytes (broadcast accounting: outer x + s_x dense
    # f32 once per node, inner messages counted on the actual payloads)
    m = W.shape[0]
    outer_bytes = 2 * tree_count(state.x) * 4 * m
    metrics = {
        "hypergrad_norm": torch.sqrt(tree_sq_norm(node_mean(u_new))),
        "x_consensus_err": consensus_error(x_new),
        "sx_consensus_err": consensus_error(s_x_new),
        "y_consensus_err": my["consensus_err"],
        "y_compress_err": my["compress_err"],
        "z_consensus_err": mz["consensus_err"],
        "measured_bytes": my["msg_bytes"] + mz["msg_bytes"] + outer_bytes,
        # per-node consensus distance (m,): sum of squares == x_consensus_err
        "x_node_dist": node_consensus_dist(x_new),
    }
    return new_state, metrics


def c2dfb_round(
    state: C2DFBState,
    generator,
    problem: BilevelProblem,
    topo: Topology,
    cfg: C2DFBConfig,
    W: torch.Tensor | None = None,
    fabric=None,
    round_idx: int = 0,
    transport=None,
) -> tuple[C2DFBState, dict]:
    """One synchronous outer round.  ``W`` overrides the static mixing
    matrix (a `repro_torch.net.dynamic` schedule's round matrix).
    ``fabric`` (a `repro_torch.net.fabric.NetworkFabric`) adds
    codec-measured ``wire_bytes`` (int) and simulated ``sim_seconds``
    (float) to the round metrics, priced as round ``round_idx``; with a
    ``W`` override only the edges W activates carry traffic.  Measuring
    the phases draws after the round (see `round_phases`).  ``transport``
    (a `repro_torch.transport.Transport`) does the same through the
    transport's pricing face; ``run(transport=)`` executes the exchanges."""
    fabric = pricing_face(fabric, transport, topo)
    W_override = W
    W = _mixing_matrix(topo, state.x) if W is None else W
    compressor = cfg.make_compressor()

    def inner_fn(st, gen, grad_fn, eta, tag):
        return inner_loop(st, gen, grad_fn, W, compressor, cfg.gamma_in, eta, cfg.K)

    new_state, metrics = c2dfb_round_core(state, generator, problem, W, cfg, inner_fn)
    if fabric is not None:
        price_round(fabric, round_phases(new_state, cfg, fabric.topo, generator), W_override, round_idx, metrics)
    return new_state, metrics


def _host(v):
    """A tensor as host numpy (a bf16 one as f32, which holds it exactly)."""
    if not torch.is_tensor(v):
        return v
    v = v.detach()
    return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()


def price_round(fabric, phases_and_labels, W_override, round_idx: int, metrics: dict) -> None:
    """Add the fabric's ``wire_bytes`` and ``sim_seconds`` of one round's
    phases to ``metrics`` (a round of C2DFB or of a baseline); a ``W``
    override (a schedule's round matrix) deactivates the links it zeroes,
    which are not priced."""
    phases, labels = phases_and_labels
    if W_override is not None:
        phases = mask_phases(phases, edges_from_weights(_host(W_override)))
    rep = fabric.simulate_round(phases, round_idx, labels=labels)
    metrics["wire_bytes"] = rep["wire_bytes"]
    metrics["sim_seconds"] = rep["sim_seconds"]


def round_phases(
    state: C2DFBState, cfg: C2DFBConfig, topo: Topology, generator=None
) -> tuple[list, list]:
    """One outer round as a sequence of barrier phases with per-edge byte
    payloads: 2 uncompressed broadcasts (x, s_x) + 2 inner loops x K steps
    x 2 codec-measured compressed messages (each node's message measured
    once on the current residuals and priced on each of its out-edges).

    A stochastic compressor draws the messages from ``generator`` in this
    order: the y loop's d then s message, then the z loop's (leaves in
    sorted-key order within a message), where the reference draws them from
    ``split(fold_in(key, 0x5EED))``.  The codec bytes of ``quant`` and
    ``kernel_quant`` do not depend on the draws; a ``randk`` message
    carries the drawn coordinates whose residual is nonzero."""
    edges = edge_list(topo)
    dx = tree_count(state.x)
    dense = {e: dx * 4 for e in edges}
    phases, labels = [dense, dense], ["out/x", "out/s_x"]
    comp = cfg.make_compressor()
    for name, inner in (("y", state.inner_y), ("z", state.inner_z)):
        ph, lb = inner_round_phases(inner, comp, topo, generator, cfg.K)
        phases += ph
        labels += [f"{name}/{s}" for s in lb]
    return phases, labels


def round_wire_bytes_measured(
    state: C2DFBState, cfg: C2DFBConfig, topo: Topology, generator=None
) -> dict:
    """Exact integer bytes per outer round, serialized by the wire codec
    (`repro_torch.net.wire`) instead of the analytic `round_wire_bytes`
    estimate.  Outer x/s_x broadcasts are dense f32; inner messages are
    measured on the current reference-point residuals."""
    m = topo.m
    comp = cfg.make_compressor()
    dense = codec_for(make_compressor("identity"))
    # one x broadcast + one s_x broadcast per node, dense f32 (as the paper)
    one_x = tree_map(lambda v: v[0], state.x)
    one_s = tree_map(lambda v: v[0], state.s_x)
    outer = (dense.tree_bytes(one_x) + dense.tree_bytes(one_s)) * m
    inner = 0
    for st in (state.inner_y, state.inner_z):
        bd, bs = inner_message_bytes(st, comp, generator)
        inner += (sum(bd) + sum(bs)) * cfg.K
    return {"outer_bytes": outer, "inner_bytes": inner, "total_bytes": outer + inner}


def round_wire_bytes(state: C2DFBState, cfg: C2DFBConfig, topo: Topology) -> dict:
    """Analytic bytes per outer round (all nodes): uncompressed x + s_x
    broadcasts, plus 2 inner loops x K steps x 2 compressed messages."""
    m = topo.m
    one_y = tree_map(lambda v: v[0], state.inner_y.d)
    one_z = tree_map(lambda v: v[0], state.inner_z.d)
    comp = cfg.make_compressor()
    dx = tree_count(state.x)
    outer = 2.0 * dx * 4 * m  # x and s_x, fp32
    inner = inner_wire_bytes_per_round(comp, one_y, cfg.K, m)
    inner += inner_wire_bytes_per_round(comp, one_z, cfg.K, m)
    return {"outer_bytes": outer, "inner_bytes": inner, "total_bytes": outer + inner}


def _check_on(tree: Tree, device: torch.device, what: str) -> None:
    for leaf in tree_leaves(tree):
        if leaf.device.type != device.type:
            raise ValueError(f"{what} lies on {leaf.device}, the run on {device}")


def run_device(problem: BilevelProblem, x0: Tree, y0: Tree, device) -> torch.device:
    """The device a run goes on (`resolve_device`), once the problem's data
    and x0/y0 are checked to lie there."""
    device = resolve_device(device)
    _check_on(x0, device, "x0")
    _check_on(y0, device, "y0")
    _check_on(problem.data_f, device, "the problem's data")
    _check_on(problem.data_g, device, "the problem's data")
    return device


def run(
    problem: BilevelProblem,
    topo: Topology,
    cfg: C2DFBConfig,
    x0: Tree,
    y0: Tree,
    T: int,
    generator=None,
    device: str | torch.device | None = None,
    schedule=None,
    fabric=None,
    obs=None,
    async_mode: str | None = None,
    staleness_bound: int = 2,
    version_rule: str = "common",
    ledger=None,
    mixing_damping: str = "none",
    damping_decay: float = 0.5,
    transport=None,
    compiled: bool = False,
) -> tuple[C2DFBState, dict]:
    """Run T synchronous outer rounds; returns the final state and the
    metrics stacked over rounds (tensors with a leading axis of T, on the
    run's device).  The problem's data and x0/y0 must lie on ``device``
    (``cuda`` unless ``device="cpu"``); x0/y0 are left untouched.

    ``schedule`` (a `repro_torch.net.dynamic.TopologySchedule`) swaps the
    static W for the schedule's per-round matrices (validated first; with
    a fabric, every active edge must be a base edge).  ``fabric`` (a
    `repro_torch.net.fabric.NetworkFabric`) appends a simulated wall-clock
    timeline, as the reference does: the phases are measured ONCE, on the
    final state's residuals (after the T rounds' draws), and priced for
    every round t, keeping only round t's active edges under a schedule;
    metrics gain ``sim_seconds`` (float64) and ``wire_bytes`` (int64) host
    numpy arrays of shape (T,).

    ``obs`` (a `repro_torch.obs.Obs`, or any object with ``emit(record)``)
    streams the reference's records: a ``scan`` span around the rounds and,
    inside it, a ``cost_analysis`` span around round 0, which runs under
    ``FlopCounterMode`` to count one round's FLOPs (the counter only
    observes, so the trajectory is that of a run without ``obs``);
    heartbeats every ``heartbeat_every`` rounds; then one ``round`` record
    a round (fleet oracle calls; FLOPs; peak device memory after round 0)
    and m ``node`` records a round.

    ``async_mode`` switches to the event-driven asynchronous engine
    (`repro_torch.async_gossip.engine.run_async`): "sync" (per-step global
    barriers, the reference timing), "bounded" (nodes run ahead up to
    ``staleness_bound`` inner steps) or "full" (never wait; mix whatever
    reference points have arrived).  It requires ``fabric``; ``ledger`` (a
    `repro_torch.async_gossip.StalenessLedger`) records per-edge staleness;
    it composes with ``schedule``.  ``version_rule`` ("common",
    "deterministic" or "acked") and ``mixing_damping`` ("none",
    "inverse-age" or "exp-decay", with ``damping_decay``) are async choices
    and raise without ``async_mode``.  With ``async_mode``,
    ``compiled=True`` runs the async engine's compiled runtime
    (`repro_torch.async_gossip.compiled.run_async_compiled`: a scheduler
    replay, then the round bodies replayed from CUDA graphs on a card);
    without it, ``compiled=True`` raises.

    ``transport`` (a `repro_torch.transport.Transport`, exclusive with
    ``fabric``) selects the backend the round's gossip runs on
    (`repro_torch.transport.engine.run_c2dfb_transport`): a `SimTransport`
    is this function with ``fabric=transport.fabric``, bit for bit; a
    `DeviceTransport` EXECUTES every exchange between the ranks of its
    mesh, carrying the real wire payloads, and meters them with the codec."""
    if transport is not None:
        if fabric is not None:
            raise ValueError("pass fabric OR transport, not both — a transport owns its pricing fabric")
        from repro_torch.transport import Transport
        from repro_torch.transport.engine import run_c2dfb_transport

        if not isinstance(transport, Transport):
            raise ValueError(
                f"transport= takes a repro_torch.transport.Transport (SimTransport, DeviceTransport), "
                f"got {type(transport).__name__}: pass a network fabric as fabric=, or as SimTransport(fabric)"
            )
        return run_c2dfb_transport(
            problem, topo, cfg, x0, y0, T, generator, transport, device=device,
            schedule=schedule, async_mode=async_mode, staleness_bound=staleness_bound,
            version_rule=version_rule, ledger=ledger, mixing_damping=mixing_damping,
            damping_decay=damping_decay, compiled=compiled, obs=obs,
        )
    if async_mode is not None:
        if fabric is None:
            raise ValueError(
                "async_mode requires a NetworkFabric: the asynchronous engine's "
                "scheduler times every message on it"
            )
        if compiled:
            from repro_torch.async_gossip.compiled import run_async_compiled

            return run_async_compiled(
                problem, topo, cfg, x0, y0, T, generator, fabric,
                policy=async_mode, bound=staleness_bound, version_rule=version_rule, ledger=ledger,
                schedule=schedule, mixing_damping=mixing_damping, damping_decay=damping_decay,
                obs=obs, device=device,
            )
        from repro_torch.async_gossip.engine import run_async

        return run_async(
            problem, topo, cfg, x0, y0, T, generator, fabric,
            policy=async_mode, bound=staleness_bound, version_rule=version_rule, ledger=ledger,
            schedule=schedule, mixing_damping=mixing_damping, damping_decay=damping_decay,
            obs=obs, device=device,
        )
    if compiled:
        raise ValueError(
            "compiled=True is the ASYNC runtime's two-phase scan; the "
            "synchronous path needs no compiled runtime — drop "
            'compiled, or pass async_mode="sync"/"bounded"/"full" (with a '
            "fabric) to run the compiled async engine"
        )
    if version_rule != "common":
        raise ValueError(
            "version_rule is an async protocol choice: the synchronous "
            "path has no versions to agree on — pass async_mode="
            '"sync"/"bounded"/"full" (with a fabric) to select '
            "'deterministic' or 'acked' timelines"
        )
    if mixing_damping != "none":
        raise ValueError(
            "mixing_damping is a staleness policy: it needs per-edge ages, "
            "which only the asynchronous engine produces — pass async_mode="
            '"sync"/"bounded"/"full" (synchronous gossip has zero ages, so '
            "damping would be a silent no-op)"
        )
    device = run_device(problem, x0, y0, device)
    obs = as_obs(obs)
    state = init_state(problem, cfg, x0, y0)
    if schedule is not None:
        # the base-edge subset check only binds when a fabric prices the
        # run (non-base edges cannot be priced)
        Ws = validate_schedule_stack(
            schedule.stack(T), T, topo.m, base=topo if fabric is not None else None
        )
        Ws = torch.as_tensor(Ws, dtype=torch.float32, device=device)
    else:
        Ws = _mixing_matrix(topo, x0).expand(T, topo.m, topo.m)

    cost = mem0 = fleet_oracles = None
    rounds = []
    with obs.span("scan", engine="sync") if obs is not None else contextlib.nullcontext():
        for t in range(T):
            if obs is not None and t == 0:
                with obs.span("cost_analysis", engine="sync"):
                    (state, metrics), cost = round_cost(
                        c2dfb_round, state, generator, problem, topo, cfg, Ws[0],
                        expected_oracles=c2dfb_oracle_calls(cfg), label="c2dfb/sync",
                    )
                fleet_oracles = {k: v * topo.m for k, v in c2dfb_oracle_calls(cfg).items()}
                mem0 = memory_peak_bytes(device)
            else:
                state, metrics = c2dfb_round(state, generator, problem, topo, cfg, W=Ws[t])
            scan_heartbeat(obs, "sync", t, metrics)
            rounds.append(metrics)
        if obs is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    stacked = {k: torch.stack([r[k] for r in rounds]) for k in rounds[0]} if rounds else {}

    if fabric is not None:
        phases, labels = round_phases(state, cfg, fabric.topo, generator)
        sim_s, wire_b = [], []
        for t in range(T):
            phases_t = phases
            if schedule is not None:
                # only the round's active links carry traffic
                act = set(schedule.active_edges(t))
                phases_t = [{e: b for e, b in ph.items() if e in act} for ph in phases]
            rep = fabric.simulate_round(phases_t, t, labels=labels)
            sim_s.append(rep["sim_seconds"])
            wire_b.append(rep["wire_bytes"])
        stacked["sim_seconds"] = np.asarray(sim_s)
        stacked["wire_bytes"] = np.asarray(wire_b, dtype=np.int64)

    if obs is not None:
        host = {k: np.asarray(_host(v)) for k, v in stacked.items()}
        for t in range(T):
            obs.round(
                "sync", t, {k: v[t] for k, v in host.items()},
                oracle_calls=fleet_oracles,
                compute_flops=cost.flops,
                hbm_bytes=cost.hbm_bytes,
                compile_seconds=cost.compile_seconds if t == 0 else None,
                memory_peak_bytes=mem0 if t == 0 else None,
            )
            # node rows: per-node consensus distance; byte and staleness
            # signals stay None (the barrier path accounts bytes fleet-wide,
            # and all ages are zero)
            x_nd = host["x_node_dist"][t]
            for i in range(x_nd.shape[0]):
                obs.node("sync", t, i, {"x_dist": x_nd[i], "compute_flops": cost.flops / topo.m})
    return state, stacked
