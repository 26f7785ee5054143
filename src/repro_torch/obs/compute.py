"""repro_torch.obs.compute — the compute half of the telemetry spine
(``repro.obs.compute``'s counterpart).

Three layers, as in the reference:

1. **Oracle counters.**  Every oracle site of
   `repro_torch.core.bilevel_problem` / `repro_torch.core.baselines` calls
   `record_oracle(kind)`, which bumps the problem's own counter
   (``problem.oracle_calls``) and a module-wide one
   (`oracle_trace_counts`).  The port runs its rounds eagerly, so a site
   counts every call, where the reference's sites count once per trace.
   The per-round call counts come from the closed-form formulas
   (`c2dfb_oracle_calls`, `mdbo_oracle_calls`, `madsbo_oracle_calls`), and
   `check_structure` pins the two views to each other: a kind the formula
   says is zero must have zero counted calls, a nonzero kind at least one.
   Beside them, `oracle_graph_traces` counts the oracle gradients that
   `repro_torch.core.oracle_graph.OracleGraphs` traced in the process and
   the wall seconds the tracing took.

2. **FLOPs, dot bytes and collective bytes of one round.**  `round_cost`
   runs a run's round 0 under ``torch.utils.flop_counter.FlopCounterMode``
   and counts its FLOPs (matrix products, as PyTorch's counter sees them),
   and beside it `DotBytes` counts ``hbm_bytes``: the operand and output
   bytes of every matrix product, the reference's definition
   (``repro.launch.hlo_cost``: lhs + rhs + out bytes of every dot), and
   `Collectives` counts ``collective_bytes``.  The
   reference walks the compiled HLO of a round that XLA has rid of dead
   code and loop-invariant work; the port's oracles do the same to their
   traced gradients (`repro_torch.core.oracle_graph`), so both fields
   equal the reference's.  On the LM bilevel problem
   (`repro_torch.core.lm_bilevel`) every oracle's count equals the
   reference's, the recompute of its checkpointed regions included
   (`repro_torch.models.remat`); a round's is one y-gradient of g and its
   backbone forward below the reference's, whose XLA round places that
   work once more (ROADMAP §C).  ``collective_bytes`` is the reference's
   output bytes of every collective of one mesh device's module, through
   every loop iteration: the port's exchange sites (the device transport's
   neighbour shifts and gathers, `repro_torch.core.gossip`) report what
   one rank receives, by the reference's collective kinds
   (`record_collective`), and a body that exchanges nothing counts 0.0, as
   the reference's synchronous, async and baseline bodies do.  With this
   counter and the dry run's `LocalCost` / `roofline.CollectiveBytes`, the
   reference's ``launch/hlo_cost.py`` has no job left in the port, which
   walks no compiled module.  ``compile_seconds`` stays None: the port's
   rounds run eagerly and compile nothing.  Where the reference's round
   body is a ``lax.cond`` (the async engine's zero-age fast path), XLA
   adds up both branches; the port's round 0 runs one, and `meta_cost`
   counts the other on the meta device, where nothing executes.

3. **Device memory.**  `memory_peak_bytes` reads the CUDA allocator's
   high-water mark on the card and returns None on the CPU, as the
   reference returns None where its backend has no allocator stats.
   Machine-dependent: parity-excluded.

Oracle taxonomy (``ORACLE_KINDS``) — by the variable differentiated:
``ul_grad`` (w.r.t. the upper-level x), ``ll_grad`` (w.r.t. a lower-level
y or z; C2DFB's y-loop objective h = f + lam*g counts as one), ``hvp``
((d^2/dy^2 g) @ v) and ``jvp`` ((d^2/dxdy g) @ v).

Per-round, per-node closed forms:

| alg    | ul_grad | ll_grad   | hvp       | jvp |
|--------|---------|-----------|-----------|-----|
| c2dfb  | 3       | 2*(K+1)   | 0         | 0   |
| mdbo   | 1       | K+1       | neumann_N | 1   |
| madsbo | 1       | K+1       | Q         | 1   |
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: every oracle kind an engine may account — `record_oracle` rejects
#: anything else so a typo'd tag cannot silently split a count
ORACLE_KINDS = ("ul_grad", "ll_grad", "hvp", "jvp")

#: module-wide oracle call counters (every problem's calls together)
_ORACLE_SITES: dict[str, int] = {}


def record_oracle(kind: str, n: int = 1, counter: dict | None = None) -> None:
    """Count ``n`` oracle calls of ``kind`` in the module-wide counters and
    in ``counter`` (a problem's ``oracle_calls``) when given."""
    if kind not in ORACLE_KINDS:
        raise ValueError(f"unknown oracle kind {kind!r}; have {ORACLE_KINDS}")
    _ORACLE_SITES[kind] = _ORACLE_SITES.get(kind, 0) + int(n)
    if counter is not None:
        counter[kind] = counter.get(kind, 0) + int(n)


def oracle_trace_counts() -> dict[str, int]:
    """Snapshot of the module-wide per-kind oracle call counters."""
    return dict(_ORACLE_SITES)


def reset_oracle_trace_counts() -> None:
    _ORACLE_SITES.clear()


def oracle_site_delta(before: dict[str, int]) -> dict[str, int]:
    """Calls counted since ``before`` (a prior `oracle_trace_counts`
    snapshot), nonzero entries only."""
    out = {}
    for k, v in _ORACLE_SITES.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


#: module-wide count of the oracle gradients traced (`OracleGraphs`, every
#: problem's together) and the wall seconds their tracing took
_GRAPH_TRACES = {"graphs": 0, "seconds": 0.0}


def record_oracle_graph_trace(seconds: float) -> None:
    """Count one traced oracle gradient that took ``seconds`` to trace."""
    _GRAPH_TRACES["graphs"] += 1
    _GRAPH_TRACES["seconds"] += float(seconds)


def oracle_graph_traces() -> dict:
    """Snapshot of the process's traced oracle gradients: ``graphs`` and
    their tracing's wall ``seconds``."""
    return dict(_GRAPH_TRACES)


# ---------------------------------------------------------------------------
# closed-form per-round per-node oracle counts
# ---------------------------------------------------------------------------


def c2dfb_oracle_calls(cfg) -> dict[str, int]:
    """C2DFB (Algorithm 1): `refresh_tracker` + K `inner_apply` gradient
    evaluations for each of the y and z loops, then `hyper_grad`'s three
    x-partials.  Fully first-order: hvp = jvp = 0 by construction."""
    return {"ul_grad": 3, "ll_grad": 2 * (int(cfg.K) + 1), "hvp": 0, "jvp": 0}


def mdbo_oracle_calls(cfg) -> dict[str, int]:
    """MDBO: K LL gossip-GD gradients + the grad_y f Neumann seed, one
    hvp per Neumann term, one cross jvp, one grad_x f."""
    return {"ul_grad": 1, "ll_grad": int(cfg.K) + 1, "hvp": int(cfg.neumann_N), "jvp": 1}


def madsbo_oracle_calls(cfg) -> dict[str, int]:
    """MA-DSBO: K LL gradients + the grad_y f HIGP target, one hvp per
    HIGP subsolver step, one cross jvp, one grad_x f."""
    return {"ul_grad": 1, "ll_grad": int(cfg.K) + 1, "hvp": int(cfg.Q), "jvp": 1}


ORACLE_FORMULAS = {
    "c2dfb": c2dfb_oracle_calls,
    "mdbo": mdbo_oracle_calls,
    "madsbo": madsbo_oracle_calls,
}


def oracle_calls_for(alg: str, cfg, m: int = 1, rounds: int = 1) -> dict[str, int]:
    """The closed-form count scaled to ``m`` nodes and ``rounds`` rounds —
    what the round records (``m`` nodes, 1 round) carry."""
    fn = ORACLE_FORMULAS.get(alg)
    if fn is None:
        raise ValueError(f"no oracle formula for {alg!r}; have {tuple(ORACLE_FORMULAS)}")
    return {k: v * int(m) * int(rounds) for k, v in fn(cfg).items()}


def device_collective_bytes(topo, cfg, x, y, fused: bool = False) -> float:
    """The closed form of one rank's ``collective_bytes`` in one round of the
    device transport (`repro_torch.transport.make_device_round`) on the
    node-stacked ``x`` and ``y`` (leaves (m, ...), each at its dtype):

    * the outer exchange of x and s_x, dense;
    * the setup exchange of the inner loops' two reference points (d_hat and
      s_hat, of y's leaves) at the start of each of the two loops, dense;
    * K steps of each loop, two residuals a step: dense leaves, or with
      ``fused`` the packed records, nb * kpad * 8 bytes a leaf (f32 values
      and int32 lanes, nb blocks of the compressor's block).

    A neighbour-shift topology moves each item once a schedule shift; an
    all-gather moves the m slices of each.  This is what the counter gives on
    the executed round (`Collectives`), written out for the sizes where no
    round is run."""
    from repro_torch.core.types import tree_leaves
    from repro_torch.transport.device import fused_pack_spec

    m = topo.m

    def rank_bytes(tree):
        return sum(v.numel() // m * v.element_size() for v in tree_leaves(tree))

    message = rank_bytes(y)
    if fused:
        block, kpad = fused_pack_spec(cfg.make_compressor())
        message = sum(-(-(v.numel() // m) // block) * kpad * 8 for v in tree_leaves(y))
    per_copy = 2 * rank_bytes(x) + 2 * 2 * rank_bytes(y) + 2 * int(cfg.K) * 2 * message
    copies = len(topo.ppermute_schedule) if topo.ppermute_schedule is not None else m
    return float(copies * per_copy)


def structure_consistent(expected: dict[str, int], sites: dict[str, int]) -> bool:
    """Do counted oracle calls agree with a closed-form count's STRUCTURE?
    A kind the formula makes zero must have zero calls (the
    C2DFB-has-no-hvp claim), a nonzero kind at least one.  Multiplicities
    are not compared."""
    for kind in ORACLE_KINDS:
        want = int(expected.get(kind, 0))
        have = int(sites.get(kind, 0))
        if (want == 0) != (have == 0):
            return False
    return True


def check_structure(label: str, expected: dict[str, int], sites: dict[str, int]) -> None:
    """Raise if a round body's counted oracle calls contradict the
    closed-form formula (see `structure_consistent`)."""
    if not structure_consistent(expected, sites):
        raise ValueError(
            f"{label}: counted oracle calls {sites} are structurally "
            f"inconsistent with the closed-form counts {expected} — an "
            "oracle moved without its formula (or vice versa)"
        )


# ---------------------------------------------------------------------------
# one round body's FLOPs
# ---------------------------------------------------------------------------


_ATEN = torch.ops.aten
#: the matrix products and the positions of their two operands (a bias
#: added by addmm / baddbmm is not an operand of the product)
DOT_OPERANDS = {
    _ATEN.mm: (0, 1), _ATEN.bmm: (0, 1), _ATEN.mv: (0, 1), _ATEN.dot: (0, 1),
    _ATEN.addmm: (1, 2), _ATEN.baddbmm: (1, 2),
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DotBytes(TorchDispatchMode):
    """Counts ``bytes``: each matrix product's two operands and its output,
    by their shapes and dtypes (``torch.matmul`` reaches the products it
    decomposes into)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        operands = DOT_OPERANDS.get(func.overloadpacket)
        if operands is not None:
            self.bytes += sum(_nbytes(args[i]) for i in operands) + _nbytes(out)
        return out


#: the open `Collectives` counters: every exchange site reports to all of them
_COLLECTIVE_COUNTERS: list = []

#: the reference's collective kinds that the port's exchanges stand for
COLLECTIVE_KINDS = ("collective-permute", "all-gather")


def record_collective(kind: str, leaves: list) -> None:
    """An exchange of the node-stacked ``leaves`` (each (m, ...), rank r's
    slice its row r), reported to the open `Collectives` counters as what one
    rank receives, at each leaf's dtype: a "collective-permute" (a neighbour
    shift) one rank's slice of each leaf, an "all-gather" the m slices of
    each.  The exchange itself is not touched."""
    if not _COLLECTIVE_COUNTERS:
        return
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; have {COLLECTIVE_KINDS}")
    for v in leaves:
        key, n = (kind, v.dtype), v.numel() if kind == "all-gather" else v.numel() // v.shape[0]
        for counter in _COLLECTIVE_COUNTERS:
            counter.elements[key] = counter.elements.get(key, 0) + n


class Collectives:
    """Counts, while open, the elements that one rank receives through the
    exchanges of a round body, by (collective kind, dtype) in ``elements``;
    ``bytes`` is their size at their dtypes.  The reference's counterpart is
    ``repro.launch.hlo_cost``'s collective bytes: the output bytes of every
    collective of one mesh device's module, through every loop iteration.
    Counters nest: an exchange reports to every open one."""

    def __init__(self):
        self.elements: dict[tuple[str, torch.dtype], int] = {}

    @property
    def bytes(self) -> int:
        return sum(n * dtype.itemsize for (_, dtype), n in self.elements.items())

    def __enter__(self) -> "Collectives":
        _COLLECTIVE_COUNTERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _COLLECTIVE_COUNTERS.remove(self)


@dataclasses.dataclass(frozen=True)
class RoundCost:
    """One round body's cost: ``flops`` of the whole node-stacked body (all
    m nodes) as ``FlopCounterMode`` counts them, ``hbm_bytes``, the operand
    and output bytes of its matrix products (`DotBytes`), and
    ``collective_bytes``, what one rank receives through its exchanges
    (`Collectives`; 0.0 for a body that exchanges nothing).
    ``compile_seconds`` is None: the port's rounds run eagerly and compile
    nothing."""

    flops: float
    hbm_bytes: float | None = None
    collective_bytes: float = 0.0
    compile_seconds: float | None = None

    def plus(self, other: "RoundCost") -> "RoundCost":
        """The cost of a body holding both bodies' work: how XLA counts a
        ``lax.cond``, whose two branches it adds up."""
        return RoundCost(flops=self.flops + other.flops, hbm_bytes=self.hbm_bytes + other.hbm_bytes,
                         collective_bytes=self.collective_bytes + other.collective_bytes)


def reset_cost_cache() -> None:
    """The reference's memo reset.  The port keeps no memo (every run
    counts its own first round, see `round_cost`), so there is nothing to
    reset."""


def round_cost(
    fn,
    *args,
    expected_oracles: dict[str, int] | None = None,
    label: str = "round",
):
    """Run ``fn(*args)`` once under ``FlopCounterMode``, `DotBytes` and
    `Collectives` and return its result with the `RoundCost` of that call,
    after checking the oracle calls it made against ``expected_oracles``
    (`check_structure`).

    The reference lowers a round without running it; the port counts a
    round it runs anyway (a run's round 0).  The counters only observe the
    operators, so the round computes what it computes without them, and its
    oracle calls count as the run's own."""
    from torch.utils.flop_counter import FlopCounterMode

    before = oracle_trace_counts()
    with FlopCounterMode(display=False) as counter, DotBytes() as dots, Collectives() as coll:
        out = fn(*args)
    if expected_oracles is not None:
        check_structure(label, expected_oracles, oracle_site_delta(before))
    return out, RoundCost(flops=float(counter.get_total_flops()), hbm_bytes=float(dots.bytes),
                          collective_bytes=float(coll.bytes))


class MetaSource:
    """The random source of a count on the meta device: draws of the
    asked shape that hold no values.  A count never advances a run's own
    source."""

    def uniform(self, shape, device, dtype=torch.float32) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device="meta")

    def choice(self, n: int, k: int, device) -> torch.Tensor:
        return torch.empty((k,), dtype=torch.int64, device="meta")


def to_meta(obj):
    """``obj`` with every tensor replaced by a meta tensor of its shape and
    dtype (through dicts, lists, tuples and named tuples); a problem (an
    object with ``on_meta``) becomes its meta copy; anything else is kept."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj, device="meta")
    if hasattr(obj, "on_meta"):
        return obj.on_meta()
    if isinstance(obj, dict):
        return {k: to_meta(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_meta(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_meta(v) for v in obj)
    return obj


def meta_cost(fn, *args) -> RoundCost:
    """The `RoundCost` of ``fn(*args)`` counted on the meta device: every
    tensor argument (and a problem's data) becomes a meta tensor of its
    shape and dtype, so the body computes shapes only and nothing runs on
    any device; the compressors take their kernels' plain versions there
    (`repro_torch.kernels.ops`).  This counts the branch of a round body
    that its round 0 did not take.  The module-wide oracle counters are
    left as they were."""
    from torch.utils.flop_counter import FlopCounterMode

    saved = oracle_trace_counts()
    try:
        with FlopCounterMode(display=False) as counter, DotBytes() as dots, Collectives() as coll:
            fn(*to_meta(args))
    finally:
        _ORACLE_SITES.clear()
        _ORACLE_SITES.update(saved)
    return RoundCost(flops=float(counter.get_total_flops()), hbm_bytes=float(dots.bytes),
                     collective_bytes=float(coll.bytes))


def memory_peak_bytes(device=None) -> int | None:
    """The CUDA allocator's high-water mark on ``device`` (None on the CPU
    or without a card).  Machine-dependent: parity-excluded."""
    if device is None or torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(device))
