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
yields zeros, not None.

``oracle_calls`` counts node-stacked oracle evaluations by kind — one
``ll_grad`` per y/z gradient (h = f + lam*g is ONE oracle) and three
``ul_grad`` per hypergradient, as the reference's ``record_oracle`` sites.
``psi`` (true hyper-objective at the consensus mean) is for evaluation
only — algorithms never touch it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.types import Tree, broadcast_nodes, tree_leaves, tree_map, tree_unflatten


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

    def record_oracle(self, kind: str, n: int = 1) -> None:
        self.oracle_calls[kind] = self.oracle_calls.get(kind, 0) + int(n)

    # ---------------- node-stacked oracles --------------------------------
    def grad_y_h(self, lam):
        """Returns grad_fn(y_stacked, x_stacked) for the y inner loop."""

        def h(x, y):
            return self.f(x, y, self.data_f) + lam * self.g(x, y, self.data_g)

        def fn(y, x):
            self.record_oracle("ll_grad")
            return grad_of_sum(h, (x, y), 1)

        return fn

    def grad_y_g(self):
        def fn(z, x):
            self.record_oracle("ll_grad")
            return grad_of_sum(self.g, (x, z, self.data_g), 1)

        return fn

    def hyper_grad(self, x, y, z, lam):
        """u_i per Eq. (4)/(24) — fully first-order hypergradient estimate."""
        self.record_oracle("ul_grad", 3)  # gfx, ggx_y, ggx_z: three x-partials
        gfx = grad_of_sum(self.f, (x, y, self.data_f), 0)
        ggx_y = grad_of_sum(self.g, (x, y, self.data_g), 0)
        ggx_z = grad_of_sum(self.g, (x, z, self.data_g), 0)
        return tree_map(lambda a, b, c: a + lam * (b - c), gfx, ggx_y, ggx_z)

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
