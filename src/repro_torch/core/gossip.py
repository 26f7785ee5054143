"""Gossip mixing (``repro.core.gossip``'s dense engine).

The consensus operator ``mix_delta(X)[i] = sum_j w_ij (X_j - X_i)`` as a
node-stacked matmul against (W - I); it works for any graph.  The mixing
*step* used by the algorithms is ``x <- x + gamma * mix_delta(x)``, i.e.
x <- (I + gamma (W - I)) x, whose spectral gap is >= gamma * rho (paper
Proposition 5).  The neighbour-exchange engines come with the transport
slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import Tree, tree_map


def mix_delta_dense(W: torch.Tensor, x: Tree) -> Tree:
    """sum_j w_ij (x_j - x_i) for node-stacked trees (leading axis m)."""
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    W_minus_I = W - eye

    def leaf(v):
        flat = v.reshape(v.shape[0], -1).to(torch.float32)
        out = W_minus_I @ flat
        # mixing arithmetic in f32, emitted at the parameter dtype (bf16 LMs)
        return out.reshape(v.shape).to(v.dtype)

    return tree_map(leaf, x)


def mix_step_dense(W: torch.Tensor, gamma, x: Tree) -> Tree:
    """x + gamma * sum_j w_ij (x_j - x_i)."""
    delta = mix_delta_dense(W, x)
    return tree_map(lambda v, d: v + gamma * d, x, delta)
