"""Exact wire-format codecs for compressed residuals (``repro.net.wire``'s
counterpart for the dense and sparse formats).

``Compressor.leaf_wire_bytes`` is an analytic float estimate; this module
serializes a compressor's *output* tensor to the byte string a deployment
would put on the wire, and deserializes it back, so ``measure`` returns
integer bytes including headers and ``decode(encode(q)) == q``.  Every
``encode`` returns the same byte string as the reference's codec on the
same values.

Formats (little-endian):

* sparse   ``b"S" | u32 d | u32 nnz | nnz*u32 idx | nnz*f32 vals``
  for magnitude sparsifiers (TopK, BlockTopK, KernelBlockTopK).  The block
  variants pack through the hand-written pack kernel
  (`repro_torch.kernels.pack_residuals`) and globalize the per-block lane
  ids.
* dense    ``b"D" | u32 d | d*f32``  for Identity.

Codecs assemble bytes on the host with numpy; the block-sparse codec packs
on the tensor's own device first.  The quantizer codec, the chunked tree
path and the packed-record helpers are not ported yet.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import compression as C
from repro_torch.core.types import Tree, tree_leaves
from repro_torch.kernels.pack_residuals import pack_sparse_blocks

_HDR_S = struct.Struct("<cII")    # kind, d, nnz
_HDR_D = struct.Struct("<cI")     # kind, d


def _host_f32(q) -> np.ndarray:
    """A flat float32 numpy copy of a tensor or array."""
    if isinstance(q, torch.Tensor):
        return q.detach().to(device="cpu", dtype=torch.float32).reshape(-1).numpy()
    return np.asarray(q, np.float32).reshape(-1)


class WireCodec:
    """Serialize one compressed leaf (flattened) to wire bytes and back."""

    def encode(self, q) -> bytes:
        raise NotImplementedError

    def decode(self, payload: bytes) -> np.ndarray:
        raise NotImplementedError

    def measure(self, q) -> int:
        return len(self.encode(q))

    # -- tree conveniences --------------------------------------------------
    def encode_tree(self, tree: Tree) -> list[bytes]:
        return [self.encode(leaf.reshape(-1)) for leaf in tree_leaves(tree)]

    def tree_bytes(self, tree: Tree) -> int:
        return sum(len(p) for p in self.encode_tree(tree))


@dataclasses.dataclass(frozen=True)
class DenseCodec(WireCodec):
    def encode(self, q) -> bytes:
        q = _host_f32(q)
        return _HDR_D.pack(b"D", q.size) + q.tobytes()

    def decode(self, payload: bytes) -> np.ndarray:
        kind, d = _HDR_D.unpack_from(payload)
        if kind != b"D":
            raise ValueError(f"not a dense payload: kind {kind!r}")
        return np.frombuffer(payload, np.float32, count=d, offset=_HDR_D.size)


@dataclasses.dataclass(frozen=True)
class SparseCodec(WireCodec):
    """(u32 index, f32 value) records for any zero-masked sparsifier."""

    def encode(self, q) -> bytes:
        q = _host_f32(q)
        idx = np.flatnonzero(q).astype(np.uint32)
        vals = q[idx]
        return _HDR_S.pack(b"S", q.size, idx.size) + idx.tobytes() + vals.tobytes()

    def decode(self, payload: bytes) -> np.ndarray:
        kind, d, nnz = _HDR_S.unpack_from(payload)
        if kind != b"S":
            raise ValueError(f"not a sparse payload: kind {kind!r}")
        off = _HDR_S.size
        idx = np.frombuffer(payload, np.uint32, count=nnz, offset=off)
        vals = np.frombuffer(payload, np.float32, count=nnz, offset=off + 4 * nnz)
        out = np.zeros(d, np.float32)
        out[idx] = vals
        return out


@dataclasses.dataclass(frozen=True)
class BlockSparseCodec(SparseCodec):
    """SparseCodec whose record extraction runs through the pack kernel — the
    deployment path for block top-k residuals.  The wire format is identical
    to SparseCodec (global u32 indices), so the two decode interchangeably;
    only the packing engine differs."""

    block: int = 1024
    ratio: float = 0.2

    def pack(self, q) -> tuple[torch.Tensor, torch.Tensor, int]:
        """One flat leaf -> its ``(vals, idx)`` block records (on the leaf's
        device) and its flat size d.  The record budget is the worst block's
        actual survivor count, so the pack never drops a record even when the
        bisection kernel keeps more than the nominal ratio*block."""
        if not isinstance(q, torch.Tensor):
            q = torch.from_numpy(np.asarray(q, np.float32))
        q = q.detach().reshape(-1).to(torch.float32)
        d = q.numel()
        nb = -(-d // self.block)
        tiles = F.pad(q, (0, nb * self.block - d)).reshape(nb, self.block)
        nnz_max = int(torch.count_nonzero(tiles, dim=1).max()) if nb else 0
        k = min(self.block, max(1, nnz_max))
        vals, idx = pack_sparse_blocks(tiles, k=k, block=self.block)
        return vals, idx, d

    def encode(self, q) -> bytes:
        return self.encode_records(*self.pack(q))

    def encode_records(self, vals: torch.Tensor, idx: torch.Tensor, d: int) -> bytes:
        """The sparse payload of one leaf from its pack records."""
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        nb = vals.shape[0]
        valid = idx < self.block
        gidx = (idx + self.block * np.arange(nb, dtype=np.int32)[:, None])[valid].astype(np.uint32)
        gvals = vals[valid]
        order = np.argsort(gidx, kind="stable")
        return _HDR_S.pack(b"S", d, gidx.size) + gidx[order].tobytes() + gvals[order].tobytes()


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def has_exact_codec(compressor: C.Compressor) -> bool:
    """True when ``codec_for`` implements this compressor's actual wire
    format (every compressor ported so far has one)."""
    return isinstance(compressor, (C.Identity, C.TopK, C.BlockTopK, C.KernelBlockTopK))


def codec_for(compressor: C.Compressor) -> WireCodec:
    """The wire codec a deployment would pair with this compressor."""
    if isinstance(compressor, (C.BlockTopK, C.KernelBlockTopK)):
        return BlockSparseCodec(block=compressor.block, ratio=compressor.ratio)
    if isinstance(compressor, C.TopK):
        return SparseCodec()
    return DenseCodec()


def measure_tree_bytes(compressor: C.Compressor, tree: Tree) -> int:
    """Exact integer wire bytes for one transmission of ``tree`` (already
    compressed)."""
    return codec_for(compressor).tree_bytes(tree)


def _is_sparse_format(compressor: C.Compressor) -> bool:
    return isinstance(compressor, (C.TopK, C.BlockTopK, C.KernelBlockTopK))


def scan_tree_bytes(compressor: C.Compressor, tree: Tree) -> torch.Tensor:
    """Exact wire bytes of one node-stacked transmission, counted on the
    payload's device without a host round trip.

    ``tree`` is the compressed payload (leading node axis m on every leaf);
    the count is per-node *broadcast* accounting — each node's message
    counted once — summed over nodes, matching
    ``codec_for(compressor).tree_bytes`` applied per node slice.  Sparse
    formats count the actual nonzeros of the payload.  Accumulates in int64
    (the reference uses int32 with x64 off; the values agree below 2 GiB).
    """
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
    for leaf in leaves:
        m = int(leaf.shape[0])
        d = int(leaf.numel() // m)
        if _is_sparse_format(compressor):
            total = total + m * _HDR_S.size + 8 * torch.count_nonzero(leaf)
        else:  # Identity: dense f32
            total = total + m * (_HDR_D.size + 4 * d)
    return total
