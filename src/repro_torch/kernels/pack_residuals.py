"""Sparse residual pack / unpack for the wire codec: the wrappers of the CUDA
kernels in ``csrc/pack_residuals.cu``, which replace the Pallas kernels
``repro.kernels.pack_residuals.pack_sparse_blocks`` and
``unpack_sparse_blocks``.

``block_topk`` emits dense tiles that are mostly zeros; a real deployment
puts only the survivors on the wire.  These kernels convert between the
dense (nb, block) tile form and the packed (nb, kpad) record form

    vals[b, j] = j-th surviving value of block b         (0.0 past nnz)
    idx[b, j]  = its lane index within the block         (block past nnz)

Survivors are the entries ``!= 0`` (so -0.0 is dropped and NaN kept), in
ascending lane order; survivors past ``kpad`` are dropped.  ``kpad`` is k
rounded up to 128 lanes, the packed row width of the reference.  The unpack
kernel has two entry points: ``unpack_sparse_blocks`` writes the (nb, block)
f32 tiles, ``unpack_sparse_blocks_into`` every rank's records straight into
a node-stacked leaf of f32 or bf16, added to a base where one is given.
The plain PyTorch versions are ``pack_sparse_blocks_ref``,
``unpack_sparse_blocks_ref`` and ``unpack_sparse_blocks_into_ref``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

LANE = 128  # packed rows are padded to this, as in the reference
MAX_UNPACK_BLOCK = 12288  # the largest block the unpack kernel is held to on the card
_LEAF_ENTRY = {torch.float32: "unpack_sparse_blocks_leaf_f32", torch.bfloat16: "unpack_sparse_blocks_leaf_bf16"}


def padded_k(k: int) -> int:
    return -(-k // LANE) * LANE


def pack_sparse_blocks_ref(x2d: torch.Tensor, k: int, block: int):
    """Plain version of the pack kernel (exclusive rank + direct store)."""
    x = x2d.to(torch.float32)
    nb = x.shape[0]
    kpad = padded_k(k)
    keep = x != 0.0
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    sel = keep & (rank < kpad)
    rows = torch.arange(nb, device=x.device).unsqueeze(1).expand(nb, block)[sel]
    lanes = torch.arange(block, device=x.device, dtype=torch.int32).expand(nb, block)[sel]
    vals = torch.zeros((nb, kpad), dtype=torch.float32, device=x.device)
    idx = torch.full((nb, kpad), block, dtype=torch.int32, device=x.device)
    vals[rows, rank[sel]] = x[sel]
    idx[rows, rank[sel]] = lanes
    return vals, idx


def unpack_sparse_blocks_ref(vals: torch.Tensor, idx: torch.Tensor, block: int):
    """Plain version of the unpack kernel: vals summed into lane idx of a
    zeroed f32 row; indices outside [0, block) write nothing."""
    nb, kpad = vals.shape
    out = torch.zeros((nb, block), dtype=torch.float32, device=vals.device)
    valid = (idx >= 0) & (idx < block)
    rows = torch.arange(nb, device=vals.device).unsqueeze(1).expand(nb, kpad)[valid]
    out.index_put_((rows, idx[valid].to(torch.int64)), vals.to(torch.float32)[valid], accumulate=True)
    return out


def unpack_sparse_blocks_into_ref(vals: torch.Tensor, idx: torch.Tensor, like: torch.Tensor, block: int,
                                  base: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the unpack kernel's leaf entry: the unpacked tiles
    cut to every rank's d values, rounded to ``like``'s dtype, then added to
    ``base`` (one rounding to that dtype, on every lane)."""
    lead = like.shape[0]
    d = math.prod(like.shape[1:])
    nb = vals.shape[0] // lead if lead else 0
    out = unpack_sparse_blocks_ref(vals, idx, block).reshape(lead, nb * block)[:, :d]
    out = out.reshape(like.shape).to(like.dtype)
    return out if base is None else base + out


def _check_device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {t.device}")
    return True


def pack_sparse_blocks(x2d: torch.Tensor, k: int, block: int):
    """(nb, block) sparse tiles -> ((nb, kpad) f32 values, (nb, kpad) i32
    local indices).  Survivors past kpad are dropped."""
    if x2d.dim() != 2 or x2d.shape[1] != block or block % LANE != 0:
        raise ValueError(f"expected (nb, {block}) with block % {LANE} == 0, got {tuple(x2d.shape)}")
    if not 1 <= k <= block:
        raise ValueError(f"k must lie in [1, {block}], got {k}")
    if not _check_device(x2d, "pack_sparse_blocks"):
        return pack_sparse_blocks_ref(x2d, k, block)
    x = x2d.to(torch.float32).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads rows as float4
    nb = x.shape[0]
    kpad = padded_k(k)
    vals = torch.empty((nb, kpad), dtype=torch.float32, device=x.device)
    idx = torch.empty((nb, kpad), dtype=torch.int32, device=x.device)
    if nb == 0:
        return vals, idx
    lib = _build.library("pack_residuals")
    stream = _build.stream_for(x)
    rc = lib.pack_sparse_blocks_f32(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), nb, block, kpad, stream
    )
    _build.check(rc, "pack_sparse_blocks")
    _build.LAUNCHES["pack_sparse_blocks"] += 1
    return vals, idx


def _check_records(vals: torch.Tensor, idx: torch.Tensor, what: str) -> bool:
    """Matching (rows, kpad) records, kpad a multiple of LANE and int32
    indices, on one device; True when that device is CUDA."""
    if vals.dim() != 2 or idx.shape != vals.shape or vals.shape[1] % LANE != 0:
        raise ValueError(
            f"expected matching (nb, kpad) vals/idx with kpad % {LANE} == 0, "
            f"got {tuple(vals.shape)} and {tuple(idx.shape)}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    on_cuda = _check_device(vals, what)
    if idx.device != vals.device:
        raise ValueError(f"vals on {vals.device} but idx on {idx.device}")
    return on_cuda


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel reads 16-byte vectors)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check_block(block: int) -> None:
    if block > MAX_UNPACK_BLOCK or block % LANE != 0:
        raise ValueError(f"block must be a multiple of {LANE} up to {MAX_UNPACK_BLOCK}, got {block}")


def unpack_sparse_blocks(vals: torch.Tensor, idx: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of ``pack_sparse_blocks``: scatter records back to dense
    (nb, block) f32 tiles.  Sentinel indices (== block) contribute nothing."""
    if not _check_records(vals, idx, "unpack_sparse_blocks"):
        return unpack_sparse_blocks_ref(vals, idx, block)
    _check_block(block)
    v = _aligned(vals.to(torch.float32))
    i = _aligned(idx)
    nb, kpad = v.shape
    out = torch.empty((nb, block), dtype=torch.float32, device=v.device)
    if nb == 0:
        return out
    lib = _build.library("pack_residuals")
    stream = _build.stream_for(v)
    rc = lib.unpack_sparse_blocks_f32(
        v.data_ptr(), i.data_ptr(), out.data_ptr(), nb, block, kpad, stream
    )
    _build.check(rc, "unpack_sparse_blocks")
    _build.LAUNCHES["unpack_sparse_blocks"] += 1
    return out


def unpack_sparse_blocks_into(vals: torch.Tensor, idx: torch.Tensor, like: torch.Tensor, block: int,
                              base: torch.Tensor | None = None) -> torch.Tensor:
    """Every rank's records straight into a leaf shaped and typed like
    ``like`` (lead, *shape), f32 or bf16: record row r = rank * nb + b, nb =
    ceil(d / block) with d = prod(shape), fills values [b * block, min((b +
    1) * block, d)) of rank's flat slice, and the padded tail of a rank's
    last block is dropped.  With ``base`` (like's shape and dtype) the
    result is ``base + unpacked`` in one pass.  Equal to
    ``unpack_sparse_blocks_into_ref``: on a CPU tensor that is what runs; on
    a CUDA tensor the kernel launches (or the call raises)."""
    on_cuda = _check_records(vals, idx, "unpack_sparse_blocks_into")
    if like.dim() < 1:
        raise ValueError("the leaf needs a leading (rank) axis")
    lead = like.shape[0]
    d = math.prod(like.shape[1:])
    nb = -(-d // block)
    if vals.shape[0] != lead * nb:
        raise ValueError(f"{vals.shape[0]} record rows for a leaf of {lead} x {d} values in blocks of {block}")
    if base is not None and (base.shape != like.shape or base.dtype != like.dtype):
        raise ValueError(f"base {tuple(base.shape)} {base.dtype} for a leaf {tuple(like.shape)} {like.dtype}")
    if like.device != vals.device or (base is not None and base.device != vals.device):
        raise ValueError(f"records on {vals.device}, leaf on {like.device}")
    if not on_cuda:
        return unpack_sparse_blocks_into_ref(vals, idx, like, block, base)
    if like.dtype not in _LEAF_ENTRY:
        raise TypeError(f"the unpack kernel writes float32 or bfloat16 leaves, got {like.dtype}")
    _check_block(block)
    v = _aligned(vals.to(torch.float32))
    i = _aligned(idx)
    b = None if base is None else _aligned(base)
    out = torch.empty(like.shape, dtype=like.dtype, device=v.device)
    if out.numel() == 0:
        return out
    fn = getattr(_build.library("pack_residuals"), _LEAF_ENTRY[like.dtype])
    rc = fn(v.data_ptr(), i.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
            lead, d, block, v.shape[1], _build.stream_for(v))
    _build.check(rc, "unpack_sparse_blocks_into")
    _build.LAUNCHES["unpack_sparse_blocks"] += 1
    return out
