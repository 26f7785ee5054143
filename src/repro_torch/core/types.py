"""Node-stacked tree helpers (``repro.core.types``'s counterpart).

Conventions
-----------
* A tree is a tensor, a dict of trees, a list of trees or None.  Dicts
  iterate in SORTED-KEY order and lists in order, and None holds no leaf
  (an SGD-momentum state's absent second moment), as ``jax.tree`` does, so a tree
  flattens to the same leaf order in both packages (the
  hyper-representation backbone ``{w1, b1, w2, b2}`` flattens as ``b1, b2,
  w1, w2``; an LM's ``{"embed", "blocks": [block_0, ...], ...}`` as
  ``blocks[0]``'s leaves, ``blocks[1]``'s, ..., then ``embed``).
* "node-stacked": every leaf carries a leading axis of size ``m`` (the
  number of decentralized nodes); ``x[i]`` is node *i*'s copy.
* The helpers are pure: they return new tensors and never update their
  inputs in place.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

Tree = Any  # torch.Tensor | dict[str, Tree] | list[Tree] | None


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {
            k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)
        }
    if isinstance(tree, list):
        return [tree_map(fn, item, *(r[i] for r in rest)) for i, item in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like: Tree, leaves: Iterable[torch.Tensor]) -> Tree:
    """A tree shaped like ``like`` holding ``leaves`` in flattening order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, c) -> Tree:
    return tree_map(lambda x: x * c, a)


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a: Tree) -> Tree:
    return tree_map(torch.zeros_like, a)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_sq_norm(a: Tree) -> torch.Tensor:
    return sum(torch.sum(x * x) for x in tree_leaves(a))


def tree_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


def node_mean(a: Tree) -> Tree:
    """Average over the node axis:  x_bar = (1/m) sum_i x_i  (keeps no node axis)."""
    return tree_map(lambda x: torch.mean(x, dim=0), a)


def broadcast_nodes(a: Tree, m: int) -> Tree:
    """Tile a per-node-free tree to the node-stacked layout (1 x ... -> m x ...).
    The copies are materialized, so no two nodes share storage."""
    return tree_map(lambda x: x.unsqueeze(0).expand((m,) + tuple(x.shape)).contiguous(), a)


def consensus_error(a: Tree) -> torch.Tensor:
    """|| x - 1 x_bar ||^2  (Frobenius over the whole stacked tree)."""
    bar = node_mean(a)
    return tree_sq_norm(tree_map(lambda x, b: x - b.unsqueeze(0), a, bar))


def node_consensus_dist(a: Tree) -> torch.Tensor:
    """Per-node consensus distance ``d_i = || x_i - x_bar ||`` as an (m,)
    vector — `consensus_error` is ``sum_i d_i**2``."""
    bar = node_mean(a)
    sq = [
        torch.sum((x - b.unsqueeze(0)).reshape(x.shape[0], -1) ** 2, dim=1)
        for x, b in zip(tree_leaves(a), tree_leaves(bar))
    ]
    return torch.sqrt(sum(sq))


def tree_count(a: Tree) -> int:
    """Number of scalar entries per *single node* (node axis excluded)."""
    return int(sum(x.numel() // x.shape[0] for x in tree_leaves(a)))


def donate_copy(tree: Any) -> Any:
    """A fresh tensor for every tensor of ``tree`` (through dicts, tuples and
    named tuples; anything else is kept), so a run that writes its carry in
    place never writes the caller's tensors: ``init_state`` aliases x0/y0,
    which callers reuse across runs."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: donate_copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(donate_copy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(donate_copy(v) for v in tree)
    return tree

