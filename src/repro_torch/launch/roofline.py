"""Roofline terms of a dry-run step (``repro.launch.roofline``'s
counterpart).

compute    = FLOPs per device            / 989e12 B/s   (H100 dense BF16)
memory     = dot bytes per device        / 3.35e12 B/s  (H100 HBM3)
collective = collective bytes per device / (18 x 25e9 B/s)  (NVLink 4)

The reference parses the collectives out of its SPMD-partitioned HLO; the
port counts the ones its step ISSUED: `CollectiveBytes` is a
``CommDebugMode`` (``torch.distributed.tensor.debug``) that also adds up,
per kind, the output bytes of every functional collective DTensor runs on
this device's shards: the reference's rule (each op's output shape,
summed by kind).  DTensor's collectives map onto the reference's five
kinds (`KINDS`); it issues no collective-permute.
"""

from __future__ import annotations

import collections

import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, NVLINK_LINKS, PEAK_FLOPS_BF16

#: the reference's collective kinds
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

#: functional collective (``torch.ops._c10d_functional``) -> its kind
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's own operator (its namespace is _dtensor)
}


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_out_bytes(o) for o in out)
    return 0


class CollectiveBytes(CommDebugMode):
    """``CommDebugMode`` that counts each functional collective and its
    output bytes by kind (`KINDS`).  It keeps CommDebugMode's per-collective
    counts (``get_comm_counts``) and leaves out its record of every other
    operator, which would cost more than the step."""

    def __init__(self):
        super().__init__()
        self.bytes_by_kind: dict = collections.defaultdict(int)
        self.counts_by_kind: dict = collections.defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars it into local operators and collectives first
        out = func(*args, **(kwargs or {}))
        packet = getattr(func, "_overloadpacket", None)
        kind = KINDS.get(getattr(packet, "__name__", "")) if packet is not None else None
        if kind is not None and getattr(func, "namespace", "") in ("_c10d_functional", "c10d_functional", "_dtensor"):
            self.comm_counts[packet] += 1
            self.bytes_by_kind[kind] += _out_bytes(out)
            self.counts_by_kind[kind] += 1
        return out

    def summary(self) -> dict:
        """The reference's ``collective_bytes`` record."""
        return {
            "bytes_by_kind": dict(self.bytes_by_kind),
            "counts_by_kind": dict(self.counts_by_kind),
            "total_bytes": int(sum(self.bytes_by_kind.values())),
        }


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float, chips: int,
                   links_per_chip: int = NVLINK_LINKS) -> dict:
    """All terms in seconds; ``flops``, ``hbm_bytes`` and ``coll_bytes`` are
    one device's."""
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = hbm_bytes / HBM_BW
    collective_s = coll_bytes / (NVLINK_BW * links_per_chip)
    dominant = max(("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
                   key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s, "dominant": dominant,
            "chips": chips}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D tokens (dense) / 6 N_active D (MoE), a step:
    forward only (2 N) for prefill and decode, one token a sequence in
    decode."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
