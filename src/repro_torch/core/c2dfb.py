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
`repro_torch.core.compression`, and deterministic compressors ignore it.  The fabric, schedule, async, transport and
telemetry arguments of the reference wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

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
    inner_wire_bytes_per_round,
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
from repro_torch.net.wire import codec_for


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
) -> tuple[C2DFBState, dict]:
    """One synchronous outer round.  ``W`` overrides the static mixing matrix."""
    W = _mixing_matrix(topo, state.x) if W is None else W
    compressor = cfg.make_compressor()

    def inner_fn(st, gen, grad_fn, eta, tag):
        return inner_loop(st, gen, grad_fn, W, compressor, cfg.gamma_in, eta, cfg.K)

    return c2dfb_round_core(state, generator, problem, W, cfg, inner_fn)


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


def run(
    problem: BilevelProblem,
    topo: Topology,
    cfg: C2DFBConfig,
    x0: Tree,
    y0: Tree,
    T: int,
    generator=None,
    device: str | torch.device | None = None,
) -> tuple[C2DFBState, dict]:
    """Run T synchronous outer rounds; returns the final state and the
    metrics stacked over rounds (tensors with a leading axis of T, on the
    run's device).  The problem's data and x0/y0 must lie on ``device``
    (``cuda`` unless ``device="cpu"``); x0/y0 are left untouched."""
    device = resolve_device(device)
    _check_on(x0, device, "x0")
    _check_on(y0, device, "y0")
    _check_on(problem.data_f, device, "the problem's data")
    _check_on(problem.data_g, device, "the problem's data")
    state = init_state(problem, cfg, x0, y0)
    W = _mixing_matrix(topo, x0)
    rounds = []
    for _ in range(T):
        state, metrics = c2dfb_round(state, generator, problem, topo, cfg, W=W)
        rounds.append(metrics)
    stacked = {k: torch.stack([r[k] for r in rounds]) for k in rounds[0]} if rounds else {}
    return state, stacked
