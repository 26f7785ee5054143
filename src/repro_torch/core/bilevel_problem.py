"""Bilevel problem container: node-stacked UL/LL objectives + derived oracles
(``repro.core.bilevel_problem``'s counterpart).

The problem owns node-stacked data shards (heterogeneity lives here) and
exposes exactly the first-order oracles C2DFB needs:

* grad_y_h   : d/dy [ f_i(x_i, y_i) + lam * g_i(x_i, y_i) ]   (inner, for y)
* grad_y_g   : d/dy   g_i(x_i, z_i)                           (inner, for z)
* hyper_grad : u_i = d/dx f_i(x_i,y_i) + lam*(d/dx g_i(x_i,y_i) - d/dx g_i(x_i,z_i))

``f`` and ``g`` take NODE-STACKED arguments and return the (m,) vector of
per-node losses.  Nodes share no parameters, so the gradient of the SUM of
the per-node losses is, node by node, the gradient of each node's own loss
(what the reference gets with ``vmap(grad)``).  A loss that does not read
the differentiated argument (the coefficient-tuning f does not read x)
yields zeros, not None.  The oracles run traced gradients
(`repro_torch.core.oracle_graph`): no forward work that a gradient never
reads, and x's share of the forward once per x, as XLA leaves the
reference's jitted round.

``oracle_calls`` counts node-stacked oracle evaluations by kind — one
``ll_grad`` per y/z gradient (h = f + lam*g is ONE oracle) and three
``ul_grad`` per hypergradient, as the reference's ``record_oracle`` sites
(`repro_torch.obs.compute.record_oracle` also counts them module-wide).
``psi`` (true hyper-objective at the consensus mean) is for evaluation
only — algorithms never touch it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.oracle_graph import OracleGraphs
from repro_torch.core.types import Tree, broadcast_nodes, tree_leaves, tree_map, tree_unflatten
from repro_torch.obs.compute import record_oracle


def grad_of_sum(fn: Callable, args: tuple, argnum: int) -> Tree:
    """Gradient of ``fn(*args).sum()`` w.r.t. the tree ``args[argnum]``."""
    with torch.enable_grad():
        wrt = tree_map(lambda v: v.detach().requires_grad_(True), args[argnum])
        call = list(args)
        call[argnum] = wrt
        leaves = tree_leaves(wrt)
        total = fn(*call).sum()
        if total.requires_grad:
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        else:  # the loss does not read the argument at all
            grads = [None] * len(leaves)
    return tree_unflatten(
        wrt,
        [torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves)],
    )


@dataclasses.dataclass(frozen=True)
class BilevelProblem:
    """f(x, y, data_f) and g(x, y, data_g) map node-stacked trees to the
    (m,) per-node losses."""

    f: Callable[[Tree, Tree, Tree], torch.Tensor]
    g: Callable[[Tree, Tree, Tree], torch.Tensor]
    data_f: Tree  # node-stacked validation shards
    data_g: Tree  # node-stacked training shards
    m: int
    oracle_calls: dict = dataclasses.field(default_factory=dict, compare=False)
    # traced oracle gradients, per problem: they capture its data
    graphs: OracleGraphs = dataclasses.field(default_factory=OracleGraphs, init=False, compare=False, repr=False)

    def record_oracle(self, kind: str, n: int = 1) -> None:
        record_oracle(kind, n, self.oracle_calls)

    # ---------------- node-stacked oracles --------------------------------
    def grad_y_h(self, lam):
        """Returns grad_fn(y_stacked, x_stacked) for the y inner loop."""

        def h(x, y):
            return self.f(x, y, self.data_f) + lam * self.g(x, y, self.data_g)

        def fn(y, x):
            self.record_oracle("ll_grad")
            return self.graphs.grad(("h", lam), h, x, y, 1)

        return fn

    def grad_y_g(self):
        def fn(z, x):
            self.record_oracle("ll_grad")
            return self.graphs.grad("g", self._g, x, z, 1)

        return fn

    def hyper_grad(self, x, y, z, lam):
        """u_i per Eq. (4)/(24) — fully first-order hypergradient estimate."""
        self.record_oracle("ul_grad", 3)  # gfx, ggx_y, ggx_z: three x-partials
        gfx = self.graphs.grad("f", self._f, x, y, 0)
        ggx_y = self.graphs.grad("g", self._g, x, y, 0)
        ggx_z = self.graphs.grad("g", self._g, x, z, 0)
        return tree_map(lambda a, b, c: a + lam * (b - c), gfx, ggx_y, ggx_z)

    def _f(self, x, y):
        return self.f(x, y, self.data_f)

    def _g(self, x, y):
        return self.g(x, y, self.data_g)

    # ---------------- evaluation-only helpers -----------------------------
    def mean_f(self, x_bar, y_bar):
        return torch.mean(
            self.f(broadcast_nodes(x_bar, self.m), broadcast_nodes(y_bar, self.m), self.data_f)
        )

    def mean_g(self, x_bar, y_bar):
        return torch.mean(
            self.g(broadcast_nodes(x_bar, self.m), broadcast_nodes(y_bar, self.m), self.data_g)
        )

    def solve_ll(self, x_bar, y0, steps=500, lr=0.1):
        """Gradient-descent LL solve at a consensus x (evaluation only)."""
        y = y0
        for _ in range(steps):
            g = grad_of_sum(self.mean_g, (x_bar, y), 1)
            y = tree_map(lambda v, gv: v - lr * gv, y, g)
        return y

    def psi(self, x_bar, y0, ll_steps=500, ll_lr=0.1):
        """psi(x) = (1/m) sum_i f_i(x, y*(x)) via an inner GD solve."""
        y_star = self.solve_ll(x_bar, y0, ll_steps, ll_lr)
        return self.mean_f(x_bar, y_star)
