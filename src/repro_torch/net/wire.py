"""Exact wire-format codecs for compressed residuals (``repro.net.wire``'s
counterpart).

``Compressor.leaf_wire_bytes`` is an analytic float estimate; this module
serializes a compressor's *output* tensor to the byte string a deployment
would put on the wire, and deserializes it back, so ``measure`` returns
integer bytes including headers.  Every ``encode`` returns the same byte
string as the reference's codec on the same values, and
``decode(encode(q)) == q`` within 1 ulp for the quantizers (the
reference's contract, see ``_dequant``) and bitwise for the rest.

Formats (little-endian):

* sparse   ``b"S" | u32 d | u32 nnz | nnz*u32 idx | nnz*f32 vals``
  for magnitude/coordinate sparsifiers (TopK, RandK, BlockTopK,
  KernelBlockTopK).  The block variants pack through the hand-written pack
  kernel (`repro_torch.kernels.pack_residuals`) and globalize the
  per-block lane ids.
* quant    ``b"Q" | u32 d | u8 bits | u32 block | nb*f32 scales | codes``
  for stochastic quantizers; codes are bit-packed to ``bits`` each.  Scales
  are recovered from the dequantized output (the argmax input element maps
  exactly to +/-scale), so the codec needs no side channel.
* dense    ``b"D" | u32 d | d*f32``  for Identity / LowRank fallbacks.

Codecs assemble bytes on the host with numpy; the block-sparse codec packs
on the tensor's own device first.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import compression as C
from repro_torch.core.types import Tree, tree_leaves, tree_unflatten
from repro_torch.kernels.pack_residuals import pack_sparse_blocks

_HDR_S = struct.Struct("<cII")    # kind, d, nnz
_HDR_Q = struct.Struct("<cIBI")   # kind, d, bits, block
_HDR_D = struct.Struct("<cI")     # kind, d


def _host_f32(q) -> np.ndarray:
    """A flat float32 numpy copy of a tensor or array."""
    if isinstance(q, torch.Tensor):
        return q.detach().to(device="cpu", dtype=torch.float32).reshape(-1).numpy()
    return np.asarray(q, np.float32).reshape(-1)


def _flatten_f32(tree: Tree) -> np.ndarray:
    """All leaves as one contiguous f32 stream (leaf order = sorted keys)."""
    leaves = [_host_f32(leaf) for leaf in tree_leaves(tree)]
    return np.concatenate(leaves) if leaves else np.zeros(0, np.float32)


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

    # -- chunked tree path (LM-scale trees) ---------------------------------
    def _check_chunkable(self, chunk: int) -> None:
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        if isinstance(self, QuantCodec):
            # quant scales are recovered from per-tile maxima; re-tiling a
            # concatenated stream changes the tiles, so chunked quant would
            # not round-trip
            raise ValueError(
                "chunked encoding is defined for sparse/dense codecs; "
                "QuantCodec tiles are position-dependent and would not "
                "survive re-chunking"
            )

    def encode_tree_chunked(self, tree: Tree, chunk: int = 1 << 16) -> list[bytes]:
        """One payload per CHUNK instead of per leaf: all leaves are
        flattened (f32) into a single stream and split into ``chunk``-element
        segments, each encoded independently (per-chunk headers instead of
        per-leaf ones, every index payload bounded by ``chunk``)."""
        self._check_chunkable(chunk)
        flat = _flatten_f32(tree)
        return [self.encode(flat[off : off + chunk]) for off in range(0, flat.size, chunk)]

    def decode_tree_chunked(self, payloads: list, tree_like: Tree) -> Tree:
        """Inverse of `encode_tree_chunked`: a tree of numpy arrays shaped
        like ``tree_like`` (whose values are ignored)."""
        flat = (
            np.concatenate([self.decode(p) for p in payloads]) if payloads
            else np.zeros(0, np.float32)
        )
        shapes = [tuple(np.shape(leaf)) for leaf in tree_leaves(tree_like)]
        total = sum(math.prod(s) for s in shapes)
        if flat.size != total:
            raise ValueError(
                f"chunked payloads decode to {flat.size} elements but the tree has {total}"
            )
        out, off = [], 0
        for shape in shapes:
            n = math.prod(shape)
            out.append(flat[off : off + n].reshape(shape))
            off += n
        return tree_unflatten(tree_like, out)

    def tree_bytes_chunked(self, tree: Tree, chunk: int = 1 << 16) -> int:
        return sum(len(p) for p in self.encode_tree_chunked(tree, chunk))


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


@dataclasses.dataclass(frozen=True)
class QuantCodec(WireCodec):
    """Bit-packed stochastic-quantization codes + per-block f32 scales.

    The compressor hands over the *dequantized* tensor; codes and scales are
    recovered exactly because the per-block argmax element always lands on
    the +/-scale grid point (valid whenever max|x| exceeded the 1e-12
    clamp).  Decode replays the canonical dequant arithmetic (``_dequant``).
    """

    bits: int = 4
    block: int = 0  # 0 = one scale for the whole leaf (StochasticQuant)

    def _blocks(self, d: int) -> int:
        return 1 if self.block == 0 else -(-d // self.block)

    def encode(self, q) -> bytes:
        q = _host_f32(q)
        d = q.size
        blk = d if self.block == 0 else self.block
        nb = self._blocks(d)
        padded = np.zeros(nb * blk, np.float32)
        padded[:d] = q
        tiles = padded.reshape(nb, blk)
        scales = np.maximum(np.abs(tiles).max(axis=1), 1e-12).astype(np.float32)
        levels = np.float32((1 << self.bits) - 1)
        y = tiles / scales[:, None]
        codes = np.rint((y + np.float32(1.0)) * np.float32(0.5) * levels)
        codes = np.clip(codes, 0, int(levels)).astype(np.uint8).reshape(-1)[:d]
        packed = _pack_bits(codes, self.bits)
        return _HDR_Q.pack(b"Q", d, self.bits, self.block) + scales.tobytes() + packed.tobytes()

    def decode(self, payload: bytes) -> np.ndarray:
        kind, d, bits, block = _HDR_Q.unpack_from(payload)
        if kind != b"Q":
            raise ValueError(f"not a quant payload: kind {kind!r}")
        blk = d if block == 0 else block
        nb = 1 if block == 0 else -(-d // block)
        off = _HDR_Q.size
        scales = np.frombuffer(payload, np.float32, count=nb, offset=off)
        codes = _unpack_bits(np.frombuffer(payload, np.uint8, offset=off + 4 * nb), bits, d)
        padded = np.zeros(nb * blk, np.float32)
        padded[:d] = codes
        out = _dequant(padded.reshape(nb, blk), scales, bits)
        return out.reshape(-1)[:d].astype(np.float32)


def _dequant(codes: np.ndarray, scales: np.ndarray, bits: int) -> np.ndarray:
    """Canonical receiver-side dequant: IEEE op-by-op float32,
    ((codes / levels) * 2 - 1) * scale, the order the port's quantizers
    (plain and kernel) compute in, so their payloads decode bit for bit.
    The reference's Pallas kernel runs the chain fused and may differ by
    1 ulp; its wire (codes and scales) is still carried losslessly."""
    levels = np.float32((1 << bits) - 1)
    deq = codes.astype(np.float32) / levels * np.float32(2.0) - np.float32(1.0)
    return deq * scales[:, None].astype(np.float32)


def _pack_bits(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack b-bit codes (uint8, values < 2^bits) into a dense byte stream."""
    cbits = np.unpackbits(codes[:, None], axis=1, count=8)[:, 8 - bits :]
    return np.packbits(cbits.reshape(-1))


def _unpack_bits(packed: np.ndarray, bits: int, n: int) -> np.ndarray:
    cbits = np.unpackbits(packed)[: n * bits].reshape(n, bits)
    pad = np.zeros((n, 8 - bits), np.uint8)
    return np.packbits(np.concatenate([pad, cbits], axis=1), axis=1).reshape(-1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def has_exact_codec(compressor: C.Compressor) -> bool:
    """True when ``codec_for`` implements this compressor's actual wire
    format.  LowRank falls back to DenseCodec, which serializes the
    reconstruction — a valid wire but NOT what a deployment would send (the
    rank-r factors), so its byte measurements must not be compared against
    ``leaf_wire_bytes``."""
    if isinstance(compressor, C.Rescaled):
        return has_exact_codec(compressor.inner)
    return isinstance(
        compressor,
        (C.Identity, C.TopK, C.RandK, C.BlockTopK, C.KernelBlockTopK, C.StochasticQuant, C.KernelQuant),
    )


def codec_for(compressor: C.Compressor) -> WireCodec:
    """The wire codec a deployment would pair with this compressor.
    Compressors without a dedicated format fall back to DenseCodec — check
    ``has_exact_codec`` before treating the measurement as deployment
    truth."""
    if isinstance(compressor, (C.BlockTopK, C.KernelBlockTopK)):
        return BlockSparseCodec(block=compressor.block, ratio=compressor.ratio)
    if isinstance(compressor, (C.TopK, C.RandK)):
        return SparseCodec()
    if isinstance(compressor, C.StochasticQuant):
        return QuantCodec(bits=compressor.bits, block=0)
    if isinstance(compressor, C.KernelQuant):
        return QuantCodec(bits=compressor.bits, block=compressor.block)
    if isinstance(compressor, C.Rescaled):
        return codec_for(compressor.inner)
    return DenseCodec()


def measure_tree_bytes(compressor: C.Compressor, tree: Tree) -> int:
    """Exact integer wire bytes for one transmission of ``tree`` (already
    compressed)."""
    return codec_for(compressor).tree_bytes(tree)


def measure_compressed_tree_bytes(compressor: C.Compressor, generator, tree: Tree) -> int:
    """Compress ``tree`` (one node's) with ``compressor`` then measure the
    wire bytes."""
    return measure_tree_bytes(compressor, compressor.compress_tree(tree, generator))


def measure_tree_bytes_chunked(compressor: C.Compressor, tree: Tree, chunk: int = 1 << 16) -> int:
    """Exact integer wire bytes of one chunked transmission (per-chunk
    headers instead of per-leaf — see `WireCodec.encode_tree_chunked`)."""
    return codec_for(compressor).tree_bytes_chunked(tree, chunk)


# ---------------------------------------------------------------------------
# packed-record path (pack records to chunked payloads, no dense tree)
# ---------------------------------------------------------------------------


def _global_records(vals_list, idx_list, leaf_sizes, block):
    """Per-leaf ``(vals, idx)`` pack records -> (flattened-tree positions,
    values) of every valid record, leaf by leaf; records past a leaf's true
    size (tile padding) are dropped."""
    if not (len(vals_list) == len(idx_list) == len(leaf_sizes)):
        raise ValueError("vals/idx/leaf_sizes must align leaf-for-leaf")
    gidx_all, vals_all = [], []
    off = 0
    for vals, idx, d in zip(vals_list, idx_list, leaf_sizes):
        vals = _host_f32(vals).reshape(np.shape(idx))
        idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
        nb = vals.shape[0]
        valid = idx < block
        g = (idx + block * np.arange(nb, dtype=np.int64)[:, None])[valid]
        v = vals[valid]
        keep = g < d
        gidx_all.append(off + g[keep])
        vals_all.append(v[keep])
        off += int(d)
    gidx = np.concatenate(gidx_all) if gidx_all else np.zeros(0, np.int64)
    vals = np.concatenate(vals_all) if vals_all else np.zeros(0, np.float32)
    return gidx, vals, off


def encode_packed_records_chunked(
    vals_list: list, idx_list: list, leaf_sizes: list[int], block: int, chunk: int = 1 << 16
) -> list[bytes]:
    """Chunked sparse wire payloads built DIRECTLY from the pack kernel's
    ``(vals, idx)`` records, where the dense residual tree never exists on
    the host.

    ``vals_list`` / ``idx_list`` hold one ``(nb, kpad)`` record pair per
    leaf (f32 values, i32 per-block lane ids, sentinel ``idx == block`` past
    a block's nnz); ``leaf_sizes`` are the UNPADDED flat sizes in leaf
    order.  Lane ids are globalized into the flattened-tree f32 stream,
    sorted ascending, and split at ``chunk`` boundaries into exactly the
    payloads ``BlockSparseCodec.encode_tree_chunked`` would emit over the
    dense tree, byte for byte."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    gidx, vals, total = _global_records(vals_list, idx_list, leaf_sizes, block)
    order = np.argsort(gidx, kind="stable")
    gidx, vals = gidx[order], vals[order]
    payloads = []
    for coff in range(0, total, chunk):
        dc = min(chunk, total - coff)
        lo = int(np.searchsorted(gidx, coff, "left"))
        hi = int(np.searchsorted(gidx, coff + dc, "left"))
        local = (gidx[lo:hi] - coff).astype(np.uint32)
        payloads.append(
            _HDR_S.pack(b"S", dc, hi - lo) + local.tobytes() + vals[lo:hi].astype(np.float32).tobytes()
        )
    return payloads


def scatter_packed_records(vals_list: list, idx_list: list, leaf_sizes: list[int], block: int) -> np.ndarray:
    """Host oracle for the packed form: scatter ``(vals, idx)`` records to
    the flattened-tree f32 stream (what a receiver reconstructs)."""
    gidx, vals, total = _global_records(vals_list, idx_list, leaf_sizes, block)
    out = np.zeros(total, np.float32)
    out[gidx] = vals
    return out


# ---------------------------------------------------------------------------
# on-device byte counting (exact per-message bytes, no host round trip)
# ---------------------------------------------------------------------------


def _is_sparse_format(compressor: C.Compressor) -> bool:
    return isinstance(compressor, (C.TopK, C.RandK, C.BlockTopK, C.KernelBlockTopK))


def scan_tree_bytes(compressor: C.Compressor, tree: Tree) -> torch.Tensor:
    """Exact wire bytes of one node-stacked transmission, counted on the
    payload's device without a host round trip.

    ``tree`` is the compressed payload (leading node axis m on every leaf);
    the count is per-node *broadcast* accounting — each node's message
    counted once — summed over nodes, matching
    ``codec_for(compressor).tree_bytes`` applied per node slice.  Sparse
    formats count the actual nonzeros of the payload; quant and dense
    formats are shape-static.  Accumulates in int64 (the reference uses
    int32 with x64 off; the values agree below 2 GiB).
    """
    if isinstance(compressor, C.Rescaled):
        return scan_tree_bytes(compressor.inner, tree)
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
    for leaf in leaves:
        m = int(leaf.shape[0])
        d = int(leaf.numel() // m)
        if _is_sparse_format(compressor):
            total = total + m * _HDR_S.size + 8 * torch.count_nonzero(leaf)
        elif isinstance(compressor, C.StochasticQuant):
            total = total + m * (_HDR_Q.size + 4 + -(-d * compressor.bits // 8))
        elif isinstance(compressor, C.KernelQuant):
            nb = -(-d // compressor.block)
            total = total + m * (_HDR_Q.size + 4 * nb + -(-d * compressor.bits // 8))
        else:  # Identity / LowRank fallback: dense f32 reconstruction
            total = total + m * (_HDR_D.size + 4 * d)
    return total
