"""Logical-axis rules -> per-dimension specs and DTensor placements
(``repro.sharding.partitioning``'s counterpart, MaxText-style).

Weights:  "embed" (d_model dims) shards over the data axes (FSDP),
          "vocab"/"ffn"/"heads_hd"/"kv_hd"/"ssm_in" shard over "model"
          (tensor parallel), "experts"/"layers" replicate.
Activations: "batch" shards over (pod, data); the KV cache's "cache_seq"
          shards over "model" (long-context decode).

`resolve` drops any axis whose mesh size does not divide the dimension,
as the reference's does: batch 1 (long_500k) or 4 KV heads on a model
axis of 16 fall back to replication instead of erroring.  It returns a
`PartitionSpec`, a tuple of one entry a dimension (a mesh axis name, a
tuple of them, or None) that prints as the reference's.  A
`NamedSharding` pairs a spec with a ``torch.distributed.device_mesh.
DeviceMesh`` and gives its DTensor placements: mesh dimension i is
``Shard(d)`` when the spec shards tensor dimension d over it, else
``Replicate()``; a dimension sharded over (pod, data) is ``Shard(d)`` on
both, in mesh order, which is the rule's order.
"""

from __future__ import annotations

import dataclasses
import math

# logical axis -> mesh axes (tried in order; dropped if not divisible)
DEFAULT_RULES: dict[str, tuple] = {
    "embed": ("data",),
    "moe_embed": ("data",),  # the experts' d_model (FSDP by default)
    "vocab": ("model",),
    "ffn": ("model",),
    "heads_hd": ("model",),
    "kv_hd": ("model",),
    "ssm_in": ("model",),
    "experts": (),
    "layers": (),
    "batch": ("pod", "data"),
    "cache_seq": ("model",),
    "seq": (),
}

# multi-pod: FSDP across the pods too
MULTIPOD_RULES = dict(DEFAULT_RULES)
MULTIPOD_RULES["embed"] = ("pod", "data")

# weight-stationary decode: weights tensor-parallel only (d_model
# replicated), so a decoded token gathers no weight shard
DECODE_RULES = dict(DEFAULT_RULES)
DECODE_RULES["embed"] = ()
MULTIPOD_DECODE_RULES = dict(MULTIPOD_RULES)
MULTIPOD_DECODE_RULES["embed"] = ()

# shard-local MoE dispatch: the experts' d_model replicated (tensor
# parallel only), so the grouped expert products contract an unsharded dim
MOE_LOCAL_RULES = dict(DEFAULT_RULES)
MOE_LOCAL_RULES["moe_embed"] = ()
MULTIPOD_MOE_LOCAL_RULES = dict(MULTIPOD_RULES)
MULTIPOD_MOE_LOCAL_RULES["moe_embed"] = ()


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh axis name, a tuple of names, or
    None (replicated); prints as the reference's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(repr(p) for p in self)})"

    __str__ = __repr__


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def rules_for_mesh(mesh, variant: str = "default") -> dict:
    multi = "pod" in mesh.mesh_dim_names
    if variant == "decode_stationary":
        return MULTIPOD_DECODE_RULES if multi else DECODE_RULES
    if variant == "moe_local":
        return MULTIPOD_MOE_LOCAL_RULES if multi else MOE_LOCAL_RULES
    return MULTIPOD_RULES if multi else DEFAULT_RULES


def resolve(logical_axes, shape, mesh, rules=None) -> PartitionSpec:
    """Map a logical-axis tuple and a concrete shape to a `PartitionSpec`."""
    rules = rules or rules_for_mesh(mesh)
    sizes = mesh_sizes(mesh)
    parts = []
    for dim, ax in zip(shape, logical_axes):
        if ax is None:
            parts.append(None)
            continue
        want = tuple(a for a in rules.get(ax, ()) if a in sizes)
        prod = math.prod(sizes[a] for a in want)
        if want and dim % prod == 0 and dim > 0:
            parts.append(want if len(want) > 1 else want[0])
        else:
            parts.append(None)
    return PartitionSpec(*parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A `PartitionSpec` on a ``DeviceMesh``: the reference's
    ``NamedSharding``, with the DTensor placements it stands for."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, p in enumerate(self.spec) if p == name or (isinstance(p, tuple) and name in p)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def local_shape(self, shape) -> tuple:
        """The shape of one device's shard of a tensor of ``shape``."""
        sizes = mesh_sizes(self.mesh)
        local = list(shape)
        for d, p in enumerate(self.spec):
            for name in (p if isinstance(p, tuple) else (p,) if p is not None else ()):
                local[d] //= sizes[name]
        return tuple(local)


def tree_shardings(spec_tree, shape_tree, mesh, rules=None):
    """Resolve a logical-spec tree (tuples at the leaves) against a tree of
    tensors of the same structure (meta tensors serve): a `NamedSharding` a
    leaf."""
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(spec_tree[k], shape_tree[k], mesh, rules) for k in spec_tree}
    if isinstance(spec_tree, list):
        return [tree_shardings(s, t, mesh, rules) for s, t in zip(spec_tree, shape_tree)]
    return NamedSharding(mesh, resolve(spec_tree, shape_tree.shape, mesh, rules))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def batch_sharding(mesh, shape, ndim: int) -> NamedSharding:
    """A (B, ...) activation's sharding: batch over (pod, data) if divisible."""
    return NamedSharding(mesh, resolve(("batch",) + (None,) * (ndim - 1), shape, mesh))
