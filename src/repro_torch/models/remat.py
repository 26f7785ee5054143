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

Policies, the reference's ``jax.checkpoint_policies``: ``"nothing"``
(``nothing_saveable``) saves no intermediate; ``"dots"``
(``dots_with_no_batch_dims_saveable``) saves the output of every product
that has no batch dimension and recomputes the rest.  In the one-model
steps those products are `repro_torch.models.layers.linear`'s (a ``bmm``
over a node axis of 1, the reference's ``x @ w``): `product` records their
outputs in the forward and serves them to the recompute, which then
multiplies only in the backward (`_SavedProduct`: the gradients of
``bmm``, by the formulas autograd uses, so the gradient is ``"nothing"``'s
bit for bit).  Attention's and the experts' products have batch
dimensions, and so does every product of a bilevel run (m nodes, the
reference's vmap), so they are recomputed.  A region checkpointed inside
a ``"dots"`` region keeps its own policy: its products are neither
recorded nor served.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.types import tree_leaves, tree_unflatten
from repro_torch.models.sharded import bmm


@torch.library.custom_op("repro_torch::barrier", mutates_args=())
def barrier(x: torch.Tensor) -> torch.Tensor:
    """An identity (a copy) that marks the start of a recompute."""
    return x.clone()


@barrier.register_fake
def _(x):
    return torch.empty_like(x)


def _barrier(t: torch.Tensor) -> torch.Tensor:
    """`barrier` of ``t``; of a DTensor's local shard, on a sharded mesh
    (the dry run), so the identity needs no sharding rule of its own."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return DTensor.from_local(barrier(t.to_local()), t.device_mesh, t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return barrier(t)


#: how many recomputes are running (a region checkpointed inside one runs plainly)
_RECOMPUTING = [0]

#: the innermost region's saved products: a list being recorded (a
#: "dots" forward), an iterator being served (its recompute), or None
_DOTS: list = [None]


class _SavedProduct(torch.autograd.Function):
    """``torch.bmm(a, b)`` whose value is one the forward saved: no product
    runs, and the backward is ``bmm``'s."""

    @staticmethod
    def forward(a, b, box):
        return box[0].detach()

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, _ = inputs
        ctx.save_for_backward(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        return bmm(grad, b.transpose(1, 2)), bmm(a.transpose(1, 2), grad), None


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` for a product with no batch dimension: recorded
    in a ``"dots"`` region's forward, served from the record in its
    recompute."""
    dots = _DOTS[-1]
    if dots is None:
        return bmm(a, b)
    if isinstance(dots, list):
        out = bmm(a, b)
        dots.append(out.detach())
        return out
    return _SavedProduct.apply(a, b, [next(dots)])


class _Box:
    """A region's policy, and the count of its outputs once its forward ran
    (an object, not a dict: the torch.func transforms copy containers)."""

    def __init__(self, policy: str):
        self.policy, self.n_out = policy, None


class _Region(torch.autograd.Function):
    """``fn(*args)`` (a region of tensor trees) whose backward recomputes it.

    Inputs: ``fn``, ``spec`` (the arguments with their float tensors taken
    out), ``box`` (a `_Box`: the policy in, the count of the region's
    outputs out) and those float tensors; the other arguments (integer
    tensors, numbers, None) stay in ``spec``.  Outputs: the region's output
    leaves, then the products a ``"dots"`` region saved (not
    differentiable)."""

    @staticmethod
    def forward(fn, spec, box, *floats):
        saved = [] if box.policy == "dots" else None
        _DOTS.append(saved)
        try:
            outs = _out_leaves(fn(*_fill(spec, floats)))
        finally:
            _DOTS.pop()
        box.n_out = len(outs)
        return (*outs, *(saved or ()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, spec, box, *floats = inputs
        ctx.fn, ctx.spec, ctx.n_floats, ctx.dots = fn, spec, len(floats), box.policy == "dots"
        saved = output[box.n_out:]
        ctx.mark_non_differentiable(*saved)
        # an output without a gradient (a saved product's, always) comes to
        # the backward as None: autograd would fill it with zeros of the
        # output's global shape, a whole plain tensor where it is a DTensor
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*floats, *saved)

    @staticmethod
    def backward(ctx, *grads):
        # the recompute's inputs: constants of this backward (a first-order
        # gradient), each through the barrier
        held = ctx.saved_tensors
        floats = [_barrier(f.detach()) for f in held[:ctx.n_floats]]
        grads = grads[:len(grads) - (len(held) - ctx.n_floats)]

        def region(*fl):
            return _out_leaves(ctx.fn(*_fill(ctx.spec, fl)))

        _RECOMPUTING[0] += 1
        _DOTS.append(iter(held[ctx.n_floats:]) if ctx.dots else None)
        try:
            if _sharded(floats):
                return (None, None, None, *_autograd_vjp(region, floats, grads))
            outs, pull = torch.func.vjp(region, *floats)
            cot = tuple(torch.zeros_like(o) if g is None else g for g, o in zip(grads, outs))
            return (None, None, None, *pull(cot))
        finally:
            _DOTS.pop()
            _RECOMPUTING[0] -= 1


def _sharded(floats) -> bool:
    """Whether the region's inputs are DTensors (the dry run's sharded
    step): its recompute then runs under autograd, where DTensor sees the
    model's own products (under ``torch.func.vjp`` it would see them
    through the transform's wrappers)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(f, DTensor) for f in floats)


def _autograd_vjp(region, floats, grads) -> tuple:
    """``torch.func.vjp(region, *floats)`` pulled back along ``grads`` by
    autograd: the same operators and derivative formulas."""
    live = [f.requires_grad_() for f in floats]
    with torch.enable_grad():
        outs = region(*live)
    cot = [torch.zeros_like(o) if g is None else g for g, o in zip(grads, outs)]
    pairs = [(o, c) for o, c in zip(outs, cot) if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], live, [c for _, c in pairs], allow_unused=True)
    return tuple(torch.zeros_like(f) if g is None else g for g, f in zip(got, live))


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


def checkpoint(fn: Callable, *args, policy: str = "nothing") -> tuple:
    """``fn(*args)``'s output leaves, as a tuple, recomputed in the backward
    pass rather than saved (with ``policy="dots"``, all but the outputs of
    its products with no batch dimension).

    ``args`` are tensors, trees of tensors (dicts, lists) or plain values;
    ``fn`` returns a tensor or a tree of them.  Only the float tensors of
    ``args`` are saved and differentiated."""
    if policy not in ("nothing", "dots"):
        raise ValueError(f"unknown recompute policy {policy!r}")
    if _RECOMPUTING[0]:
        _DOTS.append(None)  # a nested region's products are its own
        try:
            return _out_leaves(fn(*args))
        finally:
            _DOTS.pop()
    spec, floats = _split(args)
    box = _Box(policy)
    return _Region.apply(fn, spec, box, *floats)[:box.n_out]
