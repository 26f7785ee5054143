"""Recompute a region in the backward pass instead of saving its
activations (the port of the reference's ``jax.checkpoint`` regions: the
attention query chunk, the cross-entropy chunk, the transformer's repeat
of blocks and the encoder's block).  A region's float tensor arguments
are its differentiated inputs and its outputs may be several: the
transformer's repeat takes the running auxiliary loss and the modality
memory in and gives (x, aux) out, so the gradient reaches the encoder
through the memory.

``torch.utils.checkpoint`` cannot serve here: the port's oracles trace
``torch.func.grad`` under ``make_fx`` (`repro_torch.core.oracle_graph`),
and the torch.func transforms refuse saved-tensor hooks.  `checkpoint`
is a ``torch.autograd.Function`` in the ``setup_context`` style instead:
its forward runs the region and saves only the region's inputs; its
backward reruns the region on them under ``torch.func.vjp`` and pulls the
incoming gradients back through it.  The gradient is the plain one bit
for bit (the same operators on the same inputs), and the recompute is a
visible part of the traced graph, as XLA's is of the reference's.

XLA keeps a recompute apart from the forward it repeats (an optimization
barrier on its inputs), so it is counted in ``compute_flops``; it merges
two recomputes of the same inputs (the hypergradient's two x-partials of
g), and a region checkpointed inside another is not recomputed twice.
The port does the same: the oracle graphs share every node that reads x
alone by expression (`repro_torch.core.oracle_graph`), and the recompute
starts from `barrier`, an identity whose nodes differ from the forward's,
so a recompute is shared with another of the same inputs and never with
the forward; and a `checkpoint` called while a recompute runs is a plain
call, differentiated with the region around it.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.types import tree_leaves, tree_unflatten


@torch.library.custom_op("repro_torch::barrier", mutates_args=())
def barrier(x: torch.Tensor) -> torch.Tensor:
    """An identity (a copy) that marks the start of a recompute."""
    return x.clone()


@barrier.register_fake
def _(x):
    return torch.empty_like(x)


#: how many recomputes are running (a region checkpointed inside one runs plainly)
_RECOMPUTING = [0]


class _Region(torch.autograd.Function):
    """``fn(*args)`` (a region of tensor trees) whose backward recomputes it.

    Inputs: ``fn``, ``spec`` (the arguments with their float tensors taken
    out) and those float tensors; the other arguments (integer tensors,
    numbers, None) stay in ``spec``.  Outputs: the region's output leaves."""

    @staticmethod
    def forward(fn, spec, *floats):
        return _out_leaves(fn(*_fill(spec, floats)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, spec, *floats = inputs
        ctx.fn, ctx.spec = fn, spec
        ctx.save_for_backward(*floats)

    @staticmethod
    def backward(ctx, *grads):
        # the recompute's inputs: constants of this backward (a first-order
        # gradient), each through the barrier
        floats = [barrier(f.detach()) for f in ctx.saved_tensors]

        def region(*fl):
            return _out_leaves(ctx.fn(*_fill(ctx.spec, fl)))

        _RECOMPUTING[0] += 1
        try:
            outs, pull = torch.func.vjp(region, *floats)
            cot = tuple(torch.zeros_like(o) if g is None else g for g, o in zip(grads, outs))
            return (None, None, *pull(cot))
        finally:
            _RECOMPUTING[0] -= 1


def _out_leaves(out) -> tuple:
    return tuple(tree_leaves(list(out) if isinstance(out, tuple) else out))


class _Slot:
    """Where `_split` took a float tensor out of the arguments."""


_SLOT = _Slot()


def _split(args: tuple):
    """The float tensors of ``args`` (tensors, trees of them, or plain
    values), and ``args`` with a `_SLOT` in each one's place."""
    floats = []

    def take(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            floats.append(leaf)
            return _SLOT
        return leaf

    spec = [tree_unflatten(a, [take(v) for v in tree_leaves(a)]) if _is_tree(a) else a for a in args]
    return spec, floats


def _is_tree(a) -> bool:
    return isinstance(a, (torch.Tensor, dict, list))


def _fill(spec, floats):
    """The arguments of `_split`, with ``floats`` put back in order."""
    it = iter(floats)

    def put(leaf):
        return next(it) if leaf is _SLOT else leaf

    return [put(a) if a is _SLOT else tree_unflatten(a, [put(v) for v in tree_leaves(a)]) if _is_tree(a) else a
            for a in spec]


def checkpoint(fn: Callable, *args) -> tuple:
    """``fn(*args)``'s output leaves, as a tuple, recomputed in the backward
    pass rather than saved.

    ``args`` are tensors, trees of tensors (dicts, lists) or plain values;
    ``fn`` returns a tensor or a tree of them.  Only the float tensors of
    ``args`` are saved and differentiated."""
    if _RECOMPUTING[0]:
        return _out_leaves(fn(*args))
    spec, floats = _split(args)
    return _Region.apply(fn, spec, *floats)
