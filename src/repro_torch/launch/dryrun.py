"""Multi-pod dry run (``repro.launch.dryrun``'s counterpart): every (arch x
input shape x mesh) step traced over the 256- or 512-rank fake mesh, with
its per-device memory, FLOPs, dot bytes and collectives recorded.

The reference lowers and compiles each step on 512 placeholder devices and
reads XLA's analyses.  The port RUNS the step, eagerly, on fake tensors:

* the mesh is a ``DeviceMesh`` over torch's fake process group
  (`repro_torch.launch.mesh`), this process rank 0;
* parameters, optimizer state and inputs are DTensors whose local shards
  are fake tensors (``FakeTensorMode``: shapes and dtypes, no storage) on
  ``--device``, placed by the reference's rules
  (`repro_torch.sharding.partitioning`); activations are pinned by
  `install_activation_constraint`, and the outputs are redistributed to
  the reference's out-shardings, as its jit's ``out_shardings`` place them;
* `LocalCost` counts, on this device's shards (never DTensor's global
  shapes), the FLOPs of every matrix product (``torch.utils.flop_counter``'s
  formulas), their operand and output bytes (the reference's ``hlo_bytes``,
  lhs + rhs + out of every dot) and the bytes of live storage, whose peak
  gives the temp bytes; `repro_torch.launch.roofline.CollectiveBytes` counts
  the collectives DTensor issued.

The record keeps the reference's keys where they mean the same thing:
``status``, ``memory_analysis`` (argument, output and temp bytes per device;
``peak_size_in_bytes`` is the live peak, arguments included), ``hlo_flops``
and ``hlo_bytes`` (per device), ``collectives``, ``model_flops``,
``model_flops_per_chip``, ``model_flops_ratio``, ``roofline``, ``params``.
XLA's body-once keys (``xla_cost_*``, ``flops_trip_ratio``,
``flops_undercounted``) are not kept: the port's loops over layers and
chunks run eagerly, so every iteration is counted, and nothing is counted
once a body. The reference's ``launch/hlo_cost.py`` (a trip-count-aware HLO
walk) is not ported: its two jobs are this dry run's counts and, for a round
body, `repro_torch.obs.compute.round_cost` (FLOPs, dot bytes, and the bytes
of the round's collectives one device receives, counted at the exchanges by
`repro_torch.obs.compute.Collectives`). Argument bytes are the local-shard
sums of the arguments that the step reads (an operator other than a view
takes them in, or they are outputs), as jit prunes the rest: an SSM stack's
decode position, an audio model's encoder at decode. The optimizer's step
counter, a Python integer here, counts as the reference's int32 scalar; so
does decode's position where an attention layer writes its cache at it.
Output bytes are those of the outputs under the reference's out-shardings. A
case that raises is recorded as ``status: "error"`` with its traceback.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k --mesh single --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cpu
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, InputShape, get_config, input_specs, shape_applicable
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import CollectiveBytes, model_flops, roofline_terms
from repro_torch.models import layers as L
from repro_torch.models.moe import set_moe_dispatch_groups
from repro_torch.models.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.transformer import abstract_lm_params, cache_spec_tree
from repro_torch.obs.compute import DOT_OPERANDS
from repro_torch.optim.optimizers import OptState
from repro_torch.sharding.partitioning import (
    batch_sharding,
    mesh_sizes,
    replicated,
    rules_for_mesh,
    tree_shardings,
)

# jamba-398b and mixtral-8x22b keep Adam moments in bf16 (the HBM budget)
BF16_MOMENT_ARCHS = {"jamba-1.5-large-398b", "mixtral-8x22b"}
VARIANTS = ("baseline", "moe_local", "moe_local_dots", "decode_stationary", "remat_dots")
#: DTensor's sharding propagation runs each operator once on GLOBAL fake
#: shapes to learn its output's, and a strided shard's index arithmetic runs
#: tensor operators too; those calls are not this device's work
_PROPAGATION = frozenset({"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta",
                          "local_shard_size_and_offset"})
#: operators whose fake implementation returns a view of a larger buffer
#: where the card's kernel allocates the output alone: DTensor's all-to-all
#: gathers a group's worth and narrows it (on dimension 0 a view of the
#: group-sized buffer); its output counts as its own bytes
_OWN_BYTES = frozenset({"_dtensor.shard_dim_alltoall"})
#: operators whose output is their input on the card (a collective's wait)
#: where the fake implementation allocates a new storage: the output shares
#: its input's bytes, live while either is
_ALIASES = frozenset({"_c10d_functional.wait_tensor"})


@dataclasses.dataclass
class Case:
    """One step ready to trace: ``fn(*args)``, the arguments as meta tensors
    (trees), their shardings and the outputs', the config and the shape.
    Decode's ``fn`` takes the position as a tensor argument (the
    reference's int32 scalar, for its bytes) and gives the step the last
    slot's position as a Python integer; ``host_read`` names the arguments
    (by index) that the step reads so, on the host: the position, where a
    layer writes a cache slot at it."""

    fn: object
    args: tuple
    in_sh: tuple
    out_sh: object
    cfg: object
    shape: object
    host_read: tuple = ()


def _batch_shardings(mesh, specs: dict) -> dict:
    out = {}
    for k, v in specs.items():
        if k == "caches":
            continue
        out[k] = replicated(mesh) if k == "pos" else batch_sharding(mesh, v.shape, v.dim())
    return out


def _step_counter() -> torch.Tensor:
    """The optimizer's step as the reference's int32 scalar (a meta tensor)."""
    return torch.empty((), dtype=torch.int32, device="meta")


def _shape(shape) -> InputShape:
    return shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]


def config(arch: str, smoke: bool = False, layers: int | None = None):
    """``arch``'s config (its smoke config with ``smoke``), cut to its
    first ``layers`` layers (whole repeats of its pattern, at least one;
    an encoder to as many) when ``layers`` is given."""
    cfg = get_config(arch, smoke=smoke)
    if layers is None or layers >= cfg.num_layers:
        return cfg
    P = len(cfg.pattern)
    return dataclasses.replace(cfg, num_layers=max(P, layers - layers % P), enc_layers=min(cfg.enc_layers, layers))


def build_case(arch: str, shape_name, mesh, variant: str = "baseline", smoke: bool = False,
               layers: int | None = None) -> Case:
    """The reference's `build_case`: the step of the shape's kind for
    ``arch`` (its smoke config with ``smoke``, cut to ``layers``) under
    ``variant``, with the shardings of its arguments and outputs on
    ``mesh``.  ``shape_name`` names an input shape, or is an
    `InputShape`."""
    cfg = config(arch, smoke, layers)
    rules = None
    set_moe_dispatch_groups(1)
    if variant in ("moe_local", "moe_local_dots"):
        sizes = mesh_sizes(mesh)
        set_moe_dispatch_groups(sizes.get("data", 1) * sizes.get("pod", 1))
        rules = rules_for_mesh(mesh, "moe_local")
        if variant == "moe_local_dots":
            cfg = dataclasses.replace(cfg, remat_policy="dots")
    elif variant == "decode_stationary":
        rules = rules_for_mesh(mesh, "decode_stationary")
    elif variant == "remat_dots":
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    elif variant != "baseline":
        raise ValueError(variant)
    shape = _shape(shape_name)
    specs = input_specs(cfg, shape)
    pshapes, pspecs = abstract_lm_params(cfg)
    psh = tree_shardings(pspecs, pshapes, mesh, rules)
    batch_sh = _batch_shardings(mesh, specs)

    if shape.kind == "train":
        moment = torch.bfloat16 if arch in BF16_MOMENT_ARCHS else torch.float32
        train_step, opt = make_train_step(cfg, "adamw", moment_dtype=moment)
        m = tree_map(lambda p: torch.empty(p.shape, dtype=moment, device="meta"), pshapes)
        msh = tree_shardings(pspecs, m, mesh, rules)
        opt_args = {"step": _step_counter(), "m": m, "v": tree_map(torch.empty_like, m)}
        opt_sh = {"step": replicated(mesh), "m": msh, "v": msh}
        metrics_sh = {"grad_norm": replicated(mesh), "loss": replicated(mesh)}

        def fn(params, opt_state, batch):
            state = OptState(step=0, m=opt_state["m"], v=opt_state["v"])
            params, state, metrics = train_step(params, state, batch)
            return params, {"step": opt_state["step"], "m": state.m, "v": state.v}, metrics

        return Case(fn, (pshapes, opt_args, specs), (psh, opt_sh, batch_sh), (psh, opt_sh, metrics_sh), cfg, shape)

    if shape.kind == "prefill":
        prefill_step = make_prefill_step(cfg)
        B = shape.global_batch
        logits_sh = batch_sharding(mesh, (B, cfg.vocab_size), 2)
        cache_specs = cache_spec_tree(cfg)
        caches = input_specs(cfg, dataclasses.replace(shape, kind="decode"))["caches"]
        cache_sh = tree_shardings(cache_specs, caches, mesh)
        return Case(prefill_step, (pshapes, specs), (psh, batch_sh), (logits_sh, cache_sh), cfg, shape)

    # decode
    serve = make_serve_step(cfg)
    caches = specs["caches"]
    cache_sh = tree_shardings(cache_spec_tree(cfg), caches, mesh)
    B = specs["token"].shape[0]
    logits_sh = batch_sharding(mesh, (B, cfg.vocab_size), 2)
    pos = shape.seq_len - 1  # the last slot of the cache
    if "memory" in specs:
        def fn(params, token, pos_, caches, memory):
            return serve(params, token, pos, caches, memory=memory)

        args = (pshapes, specs["token"], specs["pos"], caches, specs["memory"])
        in_sh = (psh, batch_sh["token"], replicated(mesh), cache_sh, batch_sh["memory"])
    else:
        def fn(params, token, pos_, caches):
            return serve(params, token, pos, caches)

        args = (pshapes, specs["token"], specs["pos"], caches)
        in_sh = (psh, batch_sh["token"], replicated(mesh), cache_sh)
    # only a cached attention layer reads the position (an SSM stack never does)
    writes_slot = any(cfg.layer_kind(p) not in ("mamba", "cross") for p in range(len(cfg.pattern)))
    return Case(fn, args, in_sh, (logits_sh, cache_sh), cfg, shape, host_read=(2,) if writes_slot else ())


def install_activation_constraint(mesh) -> None:
    """Pin activation layouts, as the reference's launcher does: dimension
    1 (the batch, behind the node axis) over the data axes where they
    divide it, every other dimension replicated; and the weight gather
    (every dimension replicated but the last, over "model"), which the
    models never call.  Plain tensors pass unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    batch_axes = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    sizes = mesh_sizes(mesh)
    nshard = math.prod(sizes[a] for a in batch_axes)

    def constrain(x):
        if not isinstance(x, DTensor):
            return x
        shard = x.dim() > 1 and x.shape[1] % nshard == 0
        want = tuple(Shard(1) if shard and n in batch_axes else Replicate() for n in mesh.mesh_dim_names)
        return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)

    def gather(w):
        if not isinstance(w, DTensor):
            return w
        last = w.shape[-1] % sizes.get("model", 1) == 0
        want = tuple(Shard(w.dim() - 1) if last and n == "model" else Replicate() for n in mesh.mesh_dim_names)
        return w.redistribute(w.device_mesh, want)

    L.set_activation_constraint(constrain)
    L.set_weight_gather(gather)


def uninstall_activation_constraint() -> None:
    L.set_activation_constraint(None)
    L.set_weight_gather(None)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


class LocalCost(TorchDispatchMode):
    """Counts this device's work: FLOPs of the matrix products (by
    ``torch.utils.flop_counter``'s formulas), their operand and output
    bytes, and the bytes of live storages (each tracked from the operator
    that made it until it is freed; ``peak`` is the most at once).  It sees
    the operators DTensor runs on the local shards: an operator on DTensors
    is left to DTensor (NotImplemented), and the global-shape runs of
    DTensor's sharding propagation are skipped."""

    def __init__(self, count: bool = True):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.count = count
        self.flops = 0
        self.dot_bytes = 0
        self.live = 0
        self.peak = 0
        self.made: dict = collections.Counter()  # bytes of the storages each operator made
        self.read: set = set()  # the storages an operator other than a view took in
        self._seen: dict = {}
        self._allocs: dict = {}

    def track(self, t: torch.Tensor, made_by: str | None = None, own: bool = False,
              alias_of: torch.Tensor | None = None) -> None:
        """Count ``t``'s storage as live until it is freed (and its bytes
        against the operator ``made_by``); with ``own``, only ``t``'s own
        bytes of it.  With ``alias_of``, a tracked tensor whose storage
        ``t``'s stands for, the two share one count of bytes."""
        st = _storage(t)
        if st is None:
            return
        key = st._cdata
        if key in self._seen and self._seen[key]() is not None:
            return
        src = _storage(alias_of) if alias_of is not None else None
        alloc = self._allocs.get(src._cdata) if src is not None else None
        if alloc is None:
            n = _nbytes(t) if own else st.nbytes()
            if made_by is not None:
                self.made[made_by] += n
            alloc = [n, 0]  # its bytes, and how many of its storages live
            self.live += n
            self.peak = max(self.peak, self.live)
        alloc[1] += 1
        self._allocs[key] = alloc
        self._seen[key] = weakref.ref(st)
        weakref.finalize(st, self._free, key, alloc)

    def _free(self, key, alloc: list) -> None:
        self._seen.pop(key, None)
        self._allocs.pop(key, None)
        alloc[1] -= 1
        if not alloc[1]:
            self.live -= alloc[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        outs = [t for t in tree_leaves(list(out) if isinstance(out, (tuple, list)) else out)
                if isinstance(t, torch.Tensor)]
        if outs and not getattr(func, "is_view", False):  # a view, or a query (its device), reads nothing
            for t in tree_leaves([*args, *kwargs.values()]):
                st = _storage(t) if isinstance(t, torch.Tensor) else None
                if st is not None:
                    self.read.add(st._cdata)
        packet = func.overloadpacket
        if self.count and packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        if self.count and packet in DOT_OPERANDS:
            self.dot_bytes += sum(_nbytes(args[i]) for i in DOT_OPERANDS[packet]) + _nbytes(out)
        own = str(packet) in _OWN_BYTES
        alias = args[0] if str(packet) in _ALIASES else None
        for t in outs:
            self.track(t, str(packet), own, alias)
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


def _bytes_of(tree, sh_tree) -> int:
    """The local-shard bytes of a tree of tensors under its shardings."""
    if isinstance(tree, dict):
        return sum(_bytes_of(tree[k], sh_tree[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_bytes_of(t, s) for t, s in zip(tree, sh_tree))
    if isinstance(tree, torch.Tensor):
        return math.prod(sh_tree.local_shape(tree.shape)) * tree.element_size()
    return 0


def _read_bytes(tree, read: set) -> int:
    """The local-shard bytes of the DTensors of ``tree`` whose shards'
    storages are in ``read``."""
    if isinstance(tree, dict):
        return sum(_read_bytes(v, read) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_read_bytes(v, read) for v in tree)
    if isinstance(tree, torch.Tensor):
        local = tree.to_local()
        return _nbytes(local) if getattr(_storage(local), "_cdata", None) in read else 0
    return 0


def _materialize(tree, sh_tree, make_local):
    """A tree of meta tensors -> DTensors whose local shards are
    ``make_local(local_shape, dtype)``, placed by ``sh_tree``."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _materialize(tree[k], sh_tree[k], make_local) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(t, s, make_local) for t, s in zip(tree, sh_tree))
    local = make_local(sh_tree.local_shape(tree.shape), tree.dtype)
    stride = torch.empty(tree.shape, device="meta").stride()
    return DTensor.from_local(local, sh_tree.mesh, sh_tree.placements, run_check=False, shape=tree.shape,
                              stride=stride)


def _place(out, sh_tree):
    """The step's outputs redistributed to the out-shardings."""
    from torch.distributed.tensor import DTensor

    if isinstance(out, dict):
        return {k: _place(out[k], sh_tree[k]) for k in out}
    if isinstance(out, (list, tuple)):
        return type(out)(_place(o, s) for o, s in zip(out, sh_tree))
    if isinstance(out, DTensor):
        want = sh_tree.placements
        return out if tuple(out.placements) == tuple(want) else out.redistribute(out.device_mesh, want)
    return out


def _local_leaves(tree) -> list:
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(list(tree) if isinstance(tree, tuple) else tree)
            if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def host_index_math():
    """Within the block, a strided shard's size and offsets (DTensor's
    ``_StridedShard.local_shard_size_and_offset``, which splits an
    ``arange``) are computed outside the fake mode: under it the arange is
    fake and its offsets data-dependent, and the redistribution fails."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def local_shard_size_and_offset(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    cls.local_shard_size_and_offset = local_shard_size_and_offset
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


@contextlib.contextmanager
def alltoall_as_operator():
    """Within the block, DTensor's all-to-all on a CPU mesh runs as its
    operator (``_dtensor.shard_dim_alltoall``, whose fake implementation
    serves the fake mode), as it does on the card's: on a CPU mesh DTensor
    falls back to an all-gather and a chunk, which would count a group's
    worth of bytes (16 x the output on the model axis) as an all-gather
    and as live storage."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    orig = getattr(placement_types, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        group = funcol._group_or_group_name(funcol._resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    placement_types.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def run_case(case: Case, device, make_local, count: bool = True) -> dict:
    """Run ``case`` once on DTensors built by ``make_local`` (fake or real
    local shards on ``device``), under `CollectiveBytes` and `LocalCost`.
    Returns the counts, the argument and output bytes and the wall time."""
    from torch.distributed.tensor.experimental import implicit_replication

    args = _materialize(case.args, case.in_sh, make_local)
    cost, comm = LocalCost(count), CollectiveBytes()
    for t in _local_leaves(args):
        cost.track(t)
    arg_live = cost.live
    t0 = time.perf_counter()
    with implicit_replication(), alltoall_as_operator(), comm, cost:
        out = _place(case.fn(*args), case.out_sh)
    wall = time.perf_counter() - t0
    out_bytes = _bytes_of(out, case.out_sh)
    # an argument that the step never reads is no argument, as jit prunes it
    # (an SSM stack's decode position, an audio model's encoder at decode)
    kept = cost.read | {st._cdata for st in map(_storage, _local_leaves(out)) if st is not None}
    arg_bytes = sum(_bytes_of(a, s) if i in case.host_read else _read_bytes(a, kept)
                    for i, (a, s) in enumerate(zip(args, case.in_sh)))
    held = {st._cdata for st in map(_storage, _local_leaves(args)) if st is not None}
    new_out = sum(_nbytes(t) for t in _local_leaves(out) if getattr(_storage(t), "_cdata", None) not in held)
    return {
        "wall_s": wall,
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": max(0, cost.peak - arg_live - new_out),
        "peak_size_in_bytes": cost.peak,
        "flops": cost.flops,
        "dot_bytes": cost.dot_bytes,
        "collectives": comm.summary() if count else {"bytes_by_kind": {}, "counts_by_kind": {}, "total_bytes": 0},
        "made_by_op": dict(cost.made),
        "out": out,
    }


def fake_locals(device):
    """``make_local`` for `run_case`: fake shards on ``device`` (no
    storage), and the ``FakeTensorMode`` they belong to."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def make(shape, dtype):
        with mode:
            return torch.empty(shape, dtype=dtype, device=device)

    return make, mode


def dryrun_one(arch: str, shape_name, multi_pod: bool, parse_hlo: bool = True, variant: str = "baseline",
               device=None, mesh=None, smoke: bool = False, layers: int | None = None) -> dict:
    """One case's record (the reference's ``dryrun_one``): on the
    production mesh of ``multi_pod`` unless ``mesh`` is given; the config
    cut to ``layers`` layers when given (its depth only: every width is
    the config's)."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod, device=dev)
    chips = math.prod(mesh.shape)
    shape = _shape(shape_name)
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "chips": chips,
        "variant": variant,
        "device": dev.type,
    }
    cfg = config(arch, smoke, layers)
    record["layers"] = cfg.num_layers
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record.update({"status": "skipped", "reason": reason})
        return record
    install_activation_constraint(mesh)
    try:
        case = build_case(arch, shape, mesh, variant=variant, smoke=smoke, layers=layers)
        make, mode = fake_locals(dev)
        with mode, host_index_math():
            res = run_case(case, dev, make, count=parse_hlo)
        record["trace_s"] = res["wall_s"]
        record["memory_analysis"] = {k: int(res[k]) for k in (
            "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "peak_size_in_bytes")}
        flops, byts = float(res["flops"]), float(res["dot_bytes"])
        record["hlo_flops"] = flops
        record["hlo_bytes"] = byts
        record["collectives"] = res["collectives"]
        mf = model_flops(case.cfg, case.shape)
        record["model_flops"] = mf
        record["model_flops_per_chip"] = mf / chips
        record["model_flops_ratio"] = mf / (chips * flops) if flops else None
        record["roofline"] = roofline_terms(flops, byts, res["collectives"]["total_bytes"], chips)
        record["params"] = case.cfg.param_count()
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue the matrix
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"[:2000]
        record["traceback"] = _traceback()
    finally:
        uninstall_activation_constraint()
        set_moe_dispatch_groups(1)
    return record


def _traceback() -> str:
    """The current exception's traceback: its frames in this package (with
    their lines), then its last 2,000 characters."""
    lines = traceback.format_exc().splitlines()
    ours = [f"{a}\n{b}" for a, b in zip(lines, lines[1:] + [""])
            if "repro_torch" in a and a.lstrip().startswith("File")]
    return "\n".join(ours) + "\n...\n" + "\n".join(lines)[-2000:]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-hlo", action="store_true", help="skip the FLOP, dot-byte and collective counts")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--device", default=None, help="where the fake shards lie: cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None, help="cut each config to this many layers (depth only)")
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    records = []
    for multi_pod in meshes:  # one fake world a mesh: building one takes seconds
        mesh = None
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
                if args.variant != "baseline":
                    tag += f"__{args.variant}"
                if args.layers is not None:
                    tag += f"__L{args.layers}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip existing] {tag}", flush=True)
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                if mesh is None:
                    mesh = make_production_mesh(multi_pod=multi_pod, device=args.device)
                rec = dryrun_one(arch, shape_name, multi_pod, parse_hlo=not args.no_hlo, variant=args.variant,
                                 device=args.device, mesh=mesh, layers=args.layers)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
                status = rec["status"]
                extra = (f" flops={rec['hlo_flops']:.3e} coll={rec['collectives']['total_bytes']:.3e}"
                         if status == "ok" else rec.get("error", rec.get("reason", "")))
                print(f"[done] {tag}: {status} {extra}", flush=True)
    return records


if __name__ == "__main__":
    main()
