"""Traced oracle gradients: dead code removed, round-invariant work shared.

The reference jits its round, and XLA removes dead code, merges common
subexpressions and hoists loop-invariant work out of the inner loops
before the round runs (and before ``repro.obs.compute`` counts its dots).
The port runs eagerly, so it does the same to its oracles here.

Every C2DFB oracle is the gradient of a node-stacked loss L(x, v), summed
over the nodes, with respect to x (the hypergradient's x-partials) or to v
(the inner loops' y and z).  `OracleGraphs.grad` traces it once per (kind,
argument, shapes, dtypes, device) with ``make_fx(torch.func.grad(...))``;
`OracleGraphs.second_order` traces the baselines' Hessian-vector and
cross products (double backward) the same way, with (x, y) as the
invariant inputs.  Then:

* **Removes dead code.**  The backward's seed ``ones_like(loss)`` reads the
  loss, so the whole forward stays live even where the gradient never
  reads it (coefficient tuning's f has no x; its g reads x only in the
  ridge term).  The seed becomes ``ones`` of the loss's static shape, and
  the graph's dead code is eliminated: those x-partials run no logits
  product.
* **Shares round-invariant work.**  Within a round every oracle sees the
  same x and the same data, so a node that reads neither v nor anything
  computed from v is a function of x alone.  Such nodes are keyed by their
  expression, one key space for all of a problem's graphs, and each is
  computed once while x stays the same tensors: the hyper-representation
  backbone's forward runs once per data shard and round, not in every
  oracle call.  A recompute (`repro_torch.models.remat`) starts from
  ``barrier`` nodes, so its expressions differ from the forward's it
  repeats and the two are not merged, while two recomputes of the same
  inputs are, as XLA treats the reference's recompute behind its
  optimization barrier.

The losses must be pure functions of (x, v) and the problem's data (which
the traces capture as constants).  The gradients equal the untraced
autograd gradients bit for bit: the graphs run the same aten operators on
the same inputs.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core.types import Tree, tree_dot, tree_leaves, tree_unflatten
from repro_torch.obs.compute import record_oracle_graph_trace
from repro_torch.obs.timeline import ORACLE_TRACE, layer

_ATEN = torch.ops.aten


def _signature(tree: Tree):
    """A hashable (structure, shapes, dtypes, devices) of a tree."""
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, list):
        return ("list",) + tuple(_signature(item) for item in tree)
    return (tuple(tree.shape), tree.dtype, tree.device)


class _Ref:
    """An invariant node's value, by expression id, inside an op's arguments."""

    __slots__ = ("eid",)

    def __init__(self, eid: int):
        self.eid = eid


def _map(fn: Callable, a: Any) -> Any:
    if isinstance(a, (list, tuple)):
        return type(a)(_map(fn, v) for v in a)
    if isinstance(a, dict):
        return {k: _map(fn, v) for k, v in a.items()}
    return fn(a)


def _hashable(a: Any) -> Any:
    if isinstance(a, (list, tuple)):
        return tuple(_hashable(v) for v in a)
    if isinstance(a, dict):
        return tuple((k, _hashable(v)) for k, v in sorted(a.items()))
    return a


def _seed_without_loss(gm: torch.fx.GraphModule) -> None:
    """Rewrite every ``ones_like(t)`` to ``ones`` of t's static shape, dtype
    and device, so the gradient's seed no longer reads the loss."""
    for node in list(gm.graph.nodes):
        if node.op == "call_function" and node.target == _ATEN.ones_like.default:
            val = node.meta["val"]
            with gm.graph.inserting_before(node):
                ones = gm.graph.call_function(
                    _ATEN.ones.default, (list(val.shape),), {"dtype": val.dtype, "device": val.device}
                )
            node.replace_all_uses_with(ones)
            gm.graph.erase_node(node)
    gm.graph.eliminate_dead_code()


class _Trace:
    """One traced gradient, split into its invariant nodes (registered with
    the problem's `OracleGraphs` by expression) and a GraphModule of the
    rest, whose inputs are v's leaves and the invariant values it reads."""

    def __init__(self, gm: torch.fx.GraphModule, nx: int, graphs: "OracleGraphs"):
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        eid: dict[torch.fx.Node, int] = {}  # invariant node -> expression id
        for i, node in enumerate(placeholders[:nx]):
            eid[node] = graphs._intern(("x", i), ("x", i))
        variant = set(placeholders[nx:])
        for node in gm.graph.nodes:
            if node.op == "get_attr":
                const = getattr(gm, node.target)
                eid[node] = graphs._intern(("const", id(const)), ("const", const))
            elif node.op == "call_function":
                schema = getattr(node.target, "_schema", None)
                if schema is not None and schema.is_mutable:
                    raise RuntimeError(f"a traced gradient updates a tensor in place ({node.target})")
                inputs = node.all_input_nodes
                if any(n in variant for n in inputs):
                    variant.add(node)
                    continue
                key = (node.target, _hashable(_map(lambda a: ("n", eid[a]) if isinstance(a, torch.fx.Node) else a,
                                                   (node.args, node.kwargs))))
                args, kwargs = _map(lambda a: _Ref(eid[a]) if isinstance(a, torch.fx.Node) else a,
                                    (node.args, node.kwargs))
                eid[node] = graphs._intern(key, ("call", node.target, args, kwargs))
        # the variant part, reading the invariant nodes it uses as inputs
        graph = torch.fx.Graph()
        env: dict[torch.fx.Node, torch.fx.Node] = {}
        for node in placeholders[nx:]:
            env[node] = graph.placeholder(node.name)
        self.frontier: list[int] = []

        def read(n: torch.fx.Node) -> torch.fx.Node:
            if n not in env:  # an invariant value, an input of this part
                env[n] = graph.placeholder(f"inv_{len(self.frontier)}")
                self.frontier.append(eid[n])
            return env[n]

        for node in gm.graph.nodes:
            if node in variant and node.op == "call_function":
                env[node] = graph.node_copy(node, read)
            elif node.op == "output":
                # an invariant output is copied, so no caller holds the memo's tensor
                outs = [read(n) if n in variant else graph.call_function(_ATEN.clone.default, (read(n),))
                        for n in node.args[0]]
                graph.output(outs)
        self.module = torch.fx.GraphModule(gm, graph)


class OracleGraphs:
    """A problem's traced oracle gradients and the memo of their
    round-invariant values (valid while x is the same tensors)."""

    def __init__(self):
        self._traces: dict[tuple, _Trace] = {}
        self._eids: dict[Any, int] = {}  # expression -> id
        self._ops: list[tuple] = []      # id -> how to compute it
        self._memo: dict[int, torch.Tensor] = {}
        self._tokens: tuple | None = None
        self._x: list[torch.Tensor] = []  # the memo's x, kept alive: its ids key the memo
        self.traces = 0
        self.trace_seconds = 0.0  # wall seconds the traces took

    def forget(self) -> None:
        """Drop the memo and the x it was computed for: the next call
        computes its invariant values anew.  A CUDA graph capture calls it
        before (so the graph computes them from the x it holds, instead of
        reading an earlier round's values on every replay) and after (so no
        tensor of the capture stays behind in the memo)."""
        self._memo.clear()
        self._tokens, self._x = None, []

    def _intern(self, key, op) -> int:
        eid = self._eids.get(key)
        if eid is None:
            eid = self._eids[key] = len(self._ops)
            self._ops.append(op)
        return eid

    def _value(self, eid: int) -> torch.Tensor:
        val = self._memo.get(eid)
        if val is None:
            op = self._ops[eid]
            if op[0] == "x":
                val = self._x[op[1]]
            elif op[0] == "const":
                val = op[1]
            else:
                args, kwargs = _map(lambda a: self._value(a.eid) if isinstance(a, _Ref) else a, (op[2], op[3]))
                val = op[1](*args, **kwargs)
            self._memo[eid] = val
        return val

    def grad(self, kind: Any, loss: Callable[[Tree, Tree], torch.Tensor], x: Tree, v: Tree, argnum: int) -> Tree:
        """The gradient of ``loss(x, v).sum()`` with respect to x (argnum 0)
        or v (argnum 1).  ``kind`` names the loss: one loss a kind for the
        life of the problem."""
        nx = len(tree_leaves(x))

        def flat(*leaves):
            args = (tree_unflatten(x, leaves[:nx]), tree_unflatten(v, leaves[nx:]))
            return tree_leaves(torch.func.grad(lambda a, b: loss(a, b).sum(), argnums=argnum)(*args))

        outs = self._call((kind, argnum), flat, tree_leaves(x), tree_leaves(v))
        return tree_unflatten((x, v)[argnum], outs)

    def second_order(
        self, kind: Any, loss: Callable[[Tree, Tree], torch.Tensor], x: Tree, y: Tree, v: Tree, argnum: int
    ) -> Tree:
        """The derivative of <grad_y loss(x, y).sum(), v> with respect to x
        (argnum 0: the cross product (d^2/dxdy) @ v) or y (argnum 1: the
        Hessian-vector product (d^2/dy^2) @ v), by double backward.  (x, y)
        are the invariant inputs and v the variant one: within a loop that
        keeps x and y (a Neumann series, a HIGP solve) the primal forward
        runs once, and a derivative that never reads the primal gradient
        (the seed rewrite) runs none of it, as XLA leaves the reference's
        forward-over-reverse products."""
        nx, ny = len(tree_leaves(x)), len(tree_leaves(y))

        def flat(*leaves):
            xs = tree_unflatten(x, leaves[:nx])
            ys = tree_unflatten(y, leaves[nx:nx + ny])
            vs = tree_unflatten(v, leaves[nx + ny:])

            def inner(a, b):
                gy = torch.func.grad(lambda bb: loss(a, bb).sum())(b)
                return tree_dot(gy, vs)

            return tree_leaves(torch.func.grad(inner, argnums=argnum)(xs, ys))

        outs = self._call(("second_order", kind, argnum), flat, tree_leaves(x) + tree_leaves(y), tree_leaves(v))
        return tree_unflatten((x, y)[argnum], outs)

    def _call(self, kind: Any, flat: Callable, inv: list, var: list) -> list:
        """Run the traced ``flat(*inv, *var)`` (traced on first use for these
        shapes), its invariant nodes from the memo while ``inv`` stays the
        same tensors."""
        key = (kind, tuple(_signature(t) for t in inv), tuple(_signature(t) for t in var))
        trace = self._traces.get(key)
        if trace is None:
            trace = self._traces[key] = self._trace(flat, inv, var)
        tokens = tuple((id(t), t._version) for t in inv)
        if tokens != self._tokens:  # other invariant inputs: their values are not computed yet
            self._memo.clear()
            self._tokens, self._x = tokens, inv
        return trace.module(*var, *(self._value(e) for e in trace.frontier))

    def _trace(self, flat: Callable, inv: list, var: list) -> _Trace:
        with layer(ORACLE_TRACE):
            t0 = time.perf_counter()
            # traced on the real inputs, outside any counting mode around the call
            with _disable_current_modes():
                gm = make_fx(flat)(*inv, *var)
            _seed_without_loss(gm)
            trace = _Trace(gm, len(inv), self)
            seconds = time.perf_counter() - t0
        self.traces += 1
        self.trace_seconds += seconds
        record_oracle_graph_trace(seconds)
        return trace
