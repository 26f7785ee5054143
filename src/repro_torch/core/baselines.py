"""Baselines the paper compares against (``repro.core.baselines``'s
synchronous path).

* MDBO    — gossip-based decentralized SBO with a Neumann-series
            Hessian-inverse-vector approximation (Yang, Zhang & Wang 2022).
            Second-order oracles are Hessian-VECTOR products; no Hessian is
            ever materialized.
* MADSBO  — alternating decentralized SBO with a HIGP quadratic subsolver
            and moving-average hypergradient (Chen et al. 2023).
* C2DFB(nc) — ablation: same fully-first-order structure as C2DFB but with
            naive error-feedback compression (transmit Q(value + error),
            accumulate the error locally) instead of reference points.
* F2SA    — centralized fully-first-order bilevel (Kwon et al. 2023); the
            single-node oracle C2DFB should track from a global view.

All operate on node-stacked trees like `c2dfb.py`.  Oracle evaluations are
counted in ``problem.oracle_calls`` at the reference's ``record_oracle``
sites, one count a node-stacked evaluation; F2SA, which the reference does
not meter, counts ``ll_grad`` per lower-level gradient step and three
``ul_grad`` (the x-partials of f, g at y and g at z) per hypergradient.
C2DFB(nc) draws from ``generator`` in the order of
`repro_torch.core.compression` (per step: the d message, then the s one).
MDBO and MADSBO take a network ``fabric`` or a ``transport`` (their dense
phases priced as the reference prices them); `mdbo_round_async` and
`madsbo_round_async` are their staleness-gated rounds, driven by
`repro_torch.async_gossip.engine.run_baseline_async`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.bilevel_problem import BilevelProblem, grad_of_sum
from repro_torch.core.c2dfb import _mixing_matrix, price_round
from repro_torch.core.compression import Compressor
from repro_torch.core.gossip import mix_delta_dense, mix_step_dense
from repro_torch.core.inner_loop import compress_stacked, pricing_face
from repro_torch.core.topology import Topology
from repro_torch.core.types import (
    Tree,
    broadcast_nodes,
    consensus_error,
    node_consensus_dist,
    node_mean,
    tree_count,
    tree_map,
    tree_sq_norm,
)
from repro_torch.net.fabric import edge_list

# ---------------------------------------------------------------------------
# second-order oracles by double backward (never materialize Hessians)
# ---------------------------------------------------------------------------


def _hvp_yy(problem: BilevelProblem, x: Tree, y: Tree, v: Tree) -> Tree:
    """(d^2/dy^2 g_i) @ v_i for every node: the y-derivative of
    <grad_y sum_i g_i(x_i, y_i), v> (nodes share no parameters, so node by
    node this is the per-node product the reference takes with vmap).  A
    traced graph (`repro_torch.core.oracle_graph`): within a loop over v
    with x and y fixed, the primal forward runs once."""
    problem.record_oracle("hvp")
    return problem.graphs.second_order("g", problem._g, x, y, v, 1)


def _jvp_xy(problem: BilevelProblem, x: Tree, y: Tree, v: Tree) -> Tree:
    """(d^2/dxdy g_i) @ v_i for every node: grad_x differentiated along the
    y-direction v (traced: what does not reach x is not computed)."""
    problem.record_oracle("jvp")
    return problem.graphs.second_order("g", problem._g, x, y, v, 0)


def _grad_f(problem: BilevelProblem, x: Tree, y: Tree, argnum: int, kind: str) -> Tree:
    """grad of sum_i f_i with respect to x (argnum 0) or y (argnum 1), traced
    like C2DFB's oracles (an x-partial f never reads costs nothing)."""
    problem.record_oracle(kind)
    return problem.graphs.grad("f", problem._f, x, y, argnum)


def _ll_update(problem: BilevelProblem, x: Tree, eta_y: float):
    """The lower-level gossip-GD update: the mixed iterate descends along
    grad_y g at the PRE-mix iterate (one ``ll_grad`` each)."""
    grad_g = problem.grad_y_g()

    def update(mixed, pre):
        return tree_map(lambda a, g_: a - eta_y * g_, mixed, grad_g(pre, x))

    return update


def value_gossip_scan(value: Tree, W: torch.Tensor, gamma, K: int, update) -> Tree:
    """K steps of  v <- update(v + gamma * mix(v), v_pre)  — the shape of
    every baseline gossip loop (MDBO/MADSBO lower level, HIGP subsolver)."""
    for _ in range(K):
        value = update(mix_step_dense(W, gamma, value), value)
    return value


# ---------------------------------------------------------------------------
# MDBO
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MDBOConfig:
    eta_x: float = 0.05
    eta_y: float = 0.1
    gamma: float = 0.5
    K: int = 10          # LL gossip-GD steps per round
    neumann_N: int = 10  # Neumann series terms
    neumann_eta: float = 0.1


class MDBOState(NamedTuple):
    x: Tree
    y: Tree
    t: int


def mdbo_init(x0: Tree, y0: Tree) -> MDBOState:
    return MDBOState(x=x0, y=y0, t=0)


def _mdbo_round_core(
    state: MDBOState, problem: BilevelProblem, cfg: MDBOConfig, W: torch.Tensor, ll_fn
) -> tuple[MDBOState, dict]:
    """Shared MDBO round body; ``ll_fn(y0, update)`` runs the LL gossip
    loop (the synchronous `value_gossip_scan` or the async engine's
    age-gated `delayed_value_scan`)."""
    x = state.x
    y = ll_fn(state.y, _ll_update(problem, x, cfg.eta_y))

    # Hypergradient via truncated Neumann series:
    #   v approx [d2yy g]^{-1} grad_y f ;  v_{n+1} = v_n - eta*(H v_n) + eta*grad_y f
    grad_f_y = _grad_f(problem, x, y, 1, "ll_grad")  # seeds the Neumann solve
    v = tree_map(lambda b: cfg.neumann_eta * b, grad_f_y)
    for _ in range(cfg.neumann_N):
        hv = _hvp_yy(problem, x, y, v)
        v = tree_map(
            lambda vn, hvn, b: vn - cfg.neumann_eta * hvn + cfg.neumann_eta * b, v, hv, grad_f_y
        )

    cross = _jvp_xy(problem, x, y, v)
    grad_f_x = _grad_f(problem, x, y, 0, "ul_grad")
    hyper = tree_map(torch.sub, grad_f_x, cross)

    # UL: gossip + descent
    x = mix_step_dense(W, cfg.gamma, x)
    x = tree_map(lambda v_, g_: v_ - cfg.eta_x * g_, x, hyper)

    metrics = {
        "hypergrad_norm": torch.sqrt(tree_sq_norm(node_mean(hyper))),
        "x_consensus_err": consensus_error(x),
        "x_node_dist": node_consensus_dist(x),
    }
    return MDBOState(x=x, y=y, t=state.t + 1), metrics


def mdbo_round(
    state: MDBOState, problem: BilevelProblem, topo: Topology, cfg: MDBOConfig,
    W: torch.Tensor | None = None, fabric=None, round_idx: int = 0, transport=None,
) -> tuple[MDBOState, dict]:
    """One MDBO round; ``W`` overrides the static mixing matrix.  ``fabric``
    (a `repro_torch.net.fabric.NetworkFabric`) adds ``wire_bytes`` and
    ``sim_seconds`` of `mdbo_round_phases`, priced as round ``round_idx``.
    ``transport`` (a `repro_torch.transport.Transport`) prices the round
    through the transport's fabric-mirroring face instead, the same keys."""
    fabric = pricing_face(fabric, transport, topo)
    W_override = W
    W = _mixing_matrix(topo, state.x) if W is None else W
    new_state, metrics = _mdbo_round_core(
        state, problem, cfg, W, lambda y0, upd: value_gossip_scan(y0, W, cfg.gamma, cfg.K, upd)
    )
    if fabric is not None:
        price_round(fabric, mdbo_round_phases(new_state, cfg, fabric.topo), W_override, round_idx, metrics)
    return new_state, metrics


def mdbo_round_wire_bytes(state: MDBOState, cfg: MDBOConfig, topo: Topology) -> float:
    """Per round each node broadcasts: y every LL step, the Neumann iterate v
    every term (the decentralized HIGP requires consensus on v), and x once.
    All uncompressed fp32."""
    dx, dy = tree_count(state.x), tree_count(state.y)
    return float((dx + dy * cfg.K + dy * cfg.neumann_N) * 4 * topo.m)


def _dense_phases(topo: Topology, sizes_and_labels: list[tuple[int, str]]) -> tuple[list, list]:
    """Barrier phases of uncompressed f32 broadcasts for the baselines."""
    edges = edge_list(topo)
    phases = [{e: d * 4 for e in edges} for d, _ in sizes_and_labels]
    return phases, [lbl for _, lbl in sizes_and_labels]


def mdbo_round_phases(state: MDBOState, cfg: MDBOConfig, topo: Topology) -> tuple[list, list]:
    dx, dy = tree_count(state.x), tree_count(state.y)
    sizes = [(dy, f"ll{k}/y") for k in range(cfg.K)]
    sizes += [(dy, f"neumann{n}/v") for n in range(cfg.neumann_N)]
    sizes += [(dx, "ul/x")]
    return _dense_phases(topo, sizes)


# ---------------------------------------------------------------------------
# MADSBO
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MADSBOConfig:
    eta_x: float = 0.05
    eta_y: float = 0.1
    eta_v: float = 0.1   # HIGP quadratic subsolver step
    gamma: float = 0.5
    K: int = 10          # LL steps per round
    Q: int = 10          # HIGP subsolver steps
    alpha: float = 0.3   # moving-average constant


class MADSBOState(NamedTuple):
    x: Tree
    y: Tree
    v: Tree  # HIGP iterate
    u: Tree  # moving-average hypergradient
    t: int


def madsbo_init(problem: BilevelProblem, x0: Tree, y0: Tree) -> MADSBOState:
    """v0 = 0, u0 = grad_x f at the start (unmetered, as in the reference)."""
    v0 = tree_map(torch.zeros_like, y0)
    u0 = grad_of_sum(problem.f, (x0, y0, problem.data_f), 0)
    return MADSBOState(x=x0, y=y0, v=v0, u=u0, t=0)


def _madsbo_round_core(
    state: MADSBOState, problem: BilevelProblem, cfg: MADSBOConfig, W: torch.Tensor, ll_fn, higp_fn
) -> tuple[MADSBOState, dict]:
    """Shared MADSBO round body; ``ll_fn`` / ``higp_fn`` run the two gossip
    loops (synchronous scans or the async engine's age-gated scans)."""
    x, u = state.x, state.u
    y = ll_fn(state.y, _ll_update(problem, x, cfg.eta_y))

    # HIGP: min_v 0.5 v^T H v - v^T grad_y f  solved by Q gossip-GD steps
    grad_f_y = _grad_f(problem, x, y, 1, "ll_grad")  # the HIGP linear target

    def higp_update(mixed, pre):
        hv = _hvp_yy(problem, x, y, pre)
        return tree_map(lambda vn, hvn, b: vn - cfg.eta_v * (hvn - b), mixed, hv, grad_f_y)

    v = higp_fn(state.v, higp_update)

    cross = _jvp_xy(problem, x, y, v)
    grad_f_x = _grad_f(problem, x, y, 0, "ul_grad")
    p = tree_map(torch.sub, grad_f_x, cross)

    # moving-average hypergradient, then UL gossip + descent
    u = tree_map(lambda un, pn: (1 - cfg.alpha) * un + cfg.alpha * pn, u, p)
    x = mix_step_dense(W, cfg.gamma, x)
    x = tree_map(lambda a, b: a - cfg.eta_x * b, x, u)

    metrics = {
        "hypergrad_norm": torch.sqrt(tree_sq_norm(node_mean(u))),
        "x_consensus_err": consensus_error(x),
        "x_node_dist": node_consensus_dist(x),
    }
    return MADSBOState(x=x, y=y, v=v, u=u, t=state.t + 1), metrics


def madsbo_round(
    state: MADSBOState, problem: BilevelProblem, topo: Topology, cfg: MADSBOConfig,
    W: torch.Tensor | None = None, fabric=None, round_idx: int = 0, transport=None,
) -> tuple[MADSBOState, dict]:
    """One MADSBO round; ``W`` overrides the static mixing matrix.
    ``fabric`` adds ``wire_bytes`` and ``sim_seconds`` of
    `madsbo_round_phases`, priced as round ``round_idx``; ``transport``
    as in `mdbo_round`."""
    fabric = pricing_face(fabric, transport, topo)
    W_override = W
    W = _mixing_matrix(topo, state.x) if W is None else W
    new_state, metrics = _madsbo_round_core(
        state, problem, cfg, W,
        lambda y0, upd: value_gossip_scan(y0, W, cfg.gamma, cfg.K, upd),
        lambda v0, upd: value_gossip_scan(v0, W, cfg.gamma, cfg.Q, upd),
    )
    if fabric is not None:
        price_round(fabric, madsbo_round_phases(new_state, cfg, fabric.topo), W_override, round_idx, metrics)
    return new_state, metrics


def madsbo_round_wire_bytes(state: MADSBOState, cfg: MADSBOConfig, topo: Topology) -> float:
    dx, dy = tree_count(state.x), tree_count(state.y)
    return float((dx + dy * cfg.K + dy * cfg.Q) * 4 * topo.m)


def madsbo_round_phases(state: MADSBOState, cfg: MADSBOConfig, topo: Topology) -> tuple[list, list]:
    dx, dy = tree_count(state.x), tree_count(state.y)
    sizes = [(dy, f"ll{k}/y") for k in range(cfg.K)]
    sizes += [(dy, f"higp{q}/v") for q in range(cfg.Q)]
    sizes += [(dx, "ul/x")]
    return _dense_phases(topo, sizes)


# ---------------------------------------------------------------------------
# async (staleness-gated) baseline rounds — driven by
# repro_torch.async_gossip.engine.run_baseline_async
# ---------------------------------------------------------------------------


def madsbo_round_async(
    state: MADSBOState,
    problem: BilevelProblem,
    topo: Topology,
    cfg: MADSBOConfig,
    ages_ll: torch.Tensor,
    ages_higp: torch.Tensor,
    depth: int,
    delayed: bool = True,
    damping: str = "none",
    decay: float = 0.5,
    W: torch.Tensor | None = None,
) -> tuple[MADSBOState, dict]:
    """MADSBO round taking the AsyncScheduler's per-step edge ages ((K, m,
    m) and (Q, m, m) integer tensors on the run's device): the LL and HIGP
    gossip loops mix age-gated VERSIONS of the transmitted iterates (dense
    value gossip, no reference points); everything else is the shared
    `_madsbo_round_core`.  With ``delayed=False`` the synchronous scans
    run, so zero-age rounds are bit-identical to ``madsbo_round``.
    ``damping`` applies the staleness-adaptive mixing policy
    (`repro_torch.async_gossip.mixing.DAMPING_POLICIES`); ``W`` is the
    topology's mixing matrix on the run's device, made here when None."""
    from repro_torch.async_gossip.engine import delayed_value_scan

    W = _mixing_matrix(topo, state.x) if W is None else W
    if delayed:
        ll_fn = lambda y0, upd: delayed_value_scan(y0, W, cfg.gamma, ages_ll, depth, upd, damping, decay)  # noqa: E731
        higp_fn = lambda v0, upd: delayed_value_scan(v0, W, cfg.gamma, ages_higp, depth, upd, damping, decay)  # noqa: E731
    else:
        ll_fn = lambda y0, upd: value_gossip_scan(y0, W, cfg.gamma, cfg.K, upd)  # noqa: E731
        higp_fn = lambda v0, upd: value_gossip_scan(v0, W, cfg.gamma, cfg.Q, upd)  # noqa: E731
    return _madsbo_round_core(state, problem, cfg, W, ll_fn, higp_fn)


def mdbo_round_async(
    state: MDBOState,
    problem: BilevelProblem,
    topo: Topology,
    cfg: MDBOConfig,
    ages_ll: torch.Tensor,
    depth: int,
    delayed: bool = True,
    damping: str = "none",
    decay: float = 0.5,
    W: torch.Tensor | None = None,
) -> tuple[MDBOState, dict]:
    """MDBO round with a staleness-gated LL gossip loop; the Neumann series
    is local compute (no gossip in this realization) and the UL update
    stays at the barrier round boundary, both in the shared
    `_mdbo_round_core`.  ``damping`` and ``W`` as in `madsbo_round_async`."""
    from repro_torch.async_gossip.engine import delayed_value_scan

    W = _mixing_matrix(topo, state.x) if W is None else W
    if delayed:
        ll_fn = lambda y0, upd: delayed_value_scan(y0, W, cfg.gamma, ages_ll, depth, upd, damping, decay)  # noqa: E731
    else:
        ll_fn = lambda y0, upd: value_gossip_scan(y0, W, cfg.gamma, cfg.K, upd)  # noqa: E731
    return _mdbo_round_core(state, problem, cfg, W, ll_fn)


# ---------------------------------------------------------------------------
# C2DFB(nc): naive error-feedback compression ablation
# ---------------------------------------------------------------------------


class NCInnerState(NamedTuple):
    d: Tree
    e_d: Tree  # accumulated compression error of d
    s: Tree
    e_s: Tree
    g_prev: Tree


def nc_inner_init(d0: Tree, grad_fn) -> NCInnerState:
    g0 = grad_fn(d0)
    return NCInnerState(
        d=d0, e_d=tree_map(torch.zeros_like, d0), s=g0, e_s=tree_map(torch.zeros_like, g0), g_prev=g0
    )


def nc_refresh_tracker(state: NCInnerState, grad_fn) -> NCInnerState:
    g_new = grad_fn(state.d)
    s = tree_map(lambda s_, gn, gp: s_ + gn - gp, state.s, g_new, state.g_prev)
    return state._replace(s=s, g_prev=g_new)


def nc_inner_step(
    state: NCInnerState, generator, grad_fn, W: torch.Tensor, compressor: Compressor, gamma, eta
) -> NCInnerState:
    # transmit c = Q(d + e); mixing uses the received compressed values
    cd = compress_stacked(compressor, generator, tree_map(torch.add, state.d, state.e_d))
    e_d = tree_map(lambda d, e, c: d + e - c, state.d, state.e_d, cd)
    mix_d = mix_delta_dense(W, cd)
    d_new = tree_map(lambda d, md, s: d + gamma * md - eta * s, state.d, mix_d, state.s)

    g_new = grad_fn(d_new)
    cs = compress_stacked(compressor, generator, tree_map(torch.add, state.s, state.e_s))
    e_s = tree_map(lambda s, e, c: s + e - c, state.s, state.e_s, cs)
    mix_s = mix_delta_dense(W, cs)
    s_new = tree_map(
        lambda s, ms, gn, gp: s + gamma * ms + gn - gp, state.s, mix_s, g_new, state.g_prev
    )
    return NCInnerState(d=d_new, e_d=e_d, s=s_new, e_s=e_s, g_prev=g_new)


def nc_inner_loop(state, generator, grad_fn, W, compressor, gamma, eta, K) -> NCInnerState:
    for _ in range(K):
        state = nc_inner_step(state, generator, grad_fn, W, compressor, gamma, eta)
    return state


class C2DFBncState(NamedTuple):
    x: Tree
    s_x: Tree
    u_prev: Tree
    inner_y: NCInnerState
    inner_z: NCInnerState
    t: int


def c2dfb_nc_init(problem: BilevelProblem, cfg, x0: Tree, y0: Tree) -> C2DFBncState:
    grad_h = problem.grad_y_h(cfg.lam)
    grad_g = problem.grad_y_g()
    iy = nc_inner_init(y0, lambda d: grad_h(d, x0))
    iz = nc_inner_init(y0, lambda d: grad_g(d, x0))
    u0 = problem.hyper_grad(x0, y0, y0, cfg.lam)
    return C2DFBncState(x=x0, s_x=u0, u_prev=u0, inner_y=iy, inner_z=iz, t=0)


def c2dfb_nc_round(
    state: C2DFBncState, generator, problem: BilevelProblem, topo: Topology, cfg
) -> tuple[C2DFBncState, dict]:
    """cfg is a C2DFBConfig — identical hyperparameters to the main method."""
    W = _mixing_matrix(topo, state.x)
    compressor = cfg.make_compressor()

    mix_x = mix_delta_dense(W, state.x)
    x_new = tree_map(
        lambda x, mx, s: x + cfg.gamma_out * mx - cfg.eta_out * s, state.x, mix_x, state.s_x
    )

    grad_h = problem.grad_y_h(cfg.lam)
    grad_g = problem.grad_y_g()
    gy = lambda d: grad_h(d, x_new)  # noqa: E731
    gz = lambda d: grad_g(d, x_new)  # noqa: E731
    iy = nc_refresh_tracker(state.inner_y, gy)
    iz = nc_refresh_tracker(state.inner_z, gz)
    iy = nc_inner_loop(iy, generator, gy, W, compressor, cfg.gamma_in, cfg.eta_in_y, cfg.K)
    iz = nc_inner_loop(iz, generator, gz, W, compressor, cfg.gamma_in, cfg.eta_in, cfg.K)

    u_new = problem.hyper_grad(x_new, iy.d, iz.d, cfg.lam)
    mix_s = mix_delta_dense(W, state.s_x)
    s_x_new = tree_map(
        lambda s, ms, un, up: s + cfg.gamma_out * ms + un - up, state.s_x, mix_s, u_new, state.u_prev
    )
    new_state = C2DFBncState(x=x_new, s_x=s_x_new, u_prev=u_new, inner_y=iy, inner_z=iz, t=state.t + 1)
    metrics = {
        "hypergrad_norm": torch.sqrt(tree_sq_norm(node_mean(u_new))),
        "x_consensus_err": consensus_error(x_new),
    }
    return new_state, metrics


# ---------------------------------------------------------------------------
# F2SA — centralized fully-first-order reference
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class F2SAConfig:
    lam: float = 10.0
    eta_x: float = 0.1
    eta_y: float = 0.1
    K: int = 10


class F2SAState(NamedTuple):
    x: Tree  # single copy (no node axis)
    y: Tree
    z: Tree
    t: int


def f2sa_init(x0: Tree, y0: Tree) -> F2SAState:
    return F2SAState(x=x0, y=y0, z=y0, t=0)


def f2sa_round(state: F2SAState, problem: BilevelProblem, cfg: F2SAConfig) -> tuple[F2SAState, dict]:
    """One round over the pooled objective: the means over the m shards of
    f and g at one shared (x, y) (each node's loss on its own copy)."""
    m = problem.m
    x, y, z = state.x, state.y, state.z

    def mean_of(fn, data, x_, y_):
        return torch.mean(fn(broadcast_nodes(x_, m), broadcast_nodes(y_, m), data))

    def mean_h(x_, y_):
        return mean_of(problem.f, problem.data_f, x_, y_) + cfg.lam * mean_of(problem.g, problem.data_g, x_, y_)

    def mean_g(x_, y_):
        return mean_of(problem.g, problem.data_g, x_, y_)

    def gd(loss, p):
        for _ in range(cfg.K):
            problem.record_oracle("ll_grad")
            p = tree_map(lambda v, gr: v - cfg.eta_y * gr, p, grad_of_sum(loss, (x, p), 1))
        return p

    y = gd(mean_h, y)
    z = gd(mean_g, z)

    def psi_lam(x_, y_, z_):
        return mean_of(problem.f, problem.data_f, x_, y_) + cfg.lam * (
            mean_of(problem.g, problem.data_g, x_, y_) - mean_of(problem.g, problem.data_g, x_, z_)
        )

    problem.record_oracle("ul_grad", 3)
    hyper = grad_of_sum(psi_lam, (x, y, z), 0)
    x = tree_map(lambda v, gr: v - cfg.eta_x * gr, x, hyper)
    metrics = {"hypergrad_norm": torch.sqrt(tree_sq_norm(hyper))}
    return F2SAState(x=x, y=y, z=z, t=state.t + 1), metrics
