"""Block top-k residual compression by threshold bisection: the wrapper of
the CUDA kernel in ``csrc/topk_compress.cu``, which replaces the Pallas
kernel ``repro.kernels.topk_compress.block_topk_pallas``.

Each (block,)-row finds its own magnitude threshold with BISECT_ITERS rounds
of (compare + count), then masks; selection is ~k per row and the
compressor is contractive with delta = k/block.  The plain PyTorch version
is ``repro_torch.kernels.ref.block_topk_ref``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_topk_ref

MAX_BLOCK = 4096  # above 1,024: one CTA of block / 4 threads a row, at most 1,024
_ENTRY = {torch.float32: "block_topk_f32", torch.bfloat16: "block_topk_bf16"}
_LEAF_ENTRY = {torch.float32: "block_topk_leaf_f32", torch.bfloat16: "block_topk_leaf_bf16"}


def _check_launch(x: torch.Tensor, block: int, k: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"block top-k runs on cpu or cuda, got {x.device}")
    if block > MAX_BLOCK:
        raise ValueError(f"the kernel holds a row in registers: block <= {MAX_BLOCK}")
    if not 1 <= k <= block:
        raise ValueError(f"k must lie in [1, {block}], got {k}")
    if not x.is_contiguous():
        raise ValueError("block top-k needs a contiguous input")


def _launch(entry: str, x: torch.Tensor, out: torch.Tensor, nb: int, block: int, k: int, *d: int) -> None:
    fn = getattr(_build.library("topk_compress"), entry)
    rc = fn(x.data_ptr(), out.data_ptr(), nb, block, *d, int(k), _build.stream_for(x))
    _build.check(rc, "block_topk")
    _build.LAUNCHES["block_topk"] += 1


def block_topk_kernel(x2d: torch.Tensor, k: int) -> torch.Tensor:
    """x2d: (nb, block) residual blocks, f32 or bf16; keeps ~k per row by
    magnitude.  A CPU tensor goes to the plain version; a CUDA tensor to
    the kernel (or the call raises)."""
    if x2d.dim() != 2:
        raise ValueError(f"expected (nb, block), got shape {tuple(x2d.shape)}")
    nb, block = x2d.shape
    if block % 128 != 0:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    if x2d.dtype not in _ENTRY:
        raise TypeError(f"block top-k takes float32 or bfloat16, got {x2d.dtype}")
    if x2d.device.type == "cpu":
        return block_topk_ref(x2d, k)
    _check_launch(x2d, block, k)
    if x2d.data_ptr() % 16:
        x2d = x2d.clone()  # the kernel reads rows in 16-byte (f32) or 8-byte (bf16) vectors
    out = torch.empty_like(x2d)
    if nb:
        _launch(_ENTRY[x2d.dtype], x2d, out, nb, block, k)
    return out


def block_topk_leaf(flat: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """flat: (m, d) node-stacked flat leaf, f32 or bf16.  Block top-k of each
    node's blocks of ``block`` elements, its last block zero-padded: the
    result of ``block_topk_kernel`` on the (m * ceil(d / block), block)
    padded tiles, cut back to (m, d).  On a CUDA tensor with d % 4 == 0 the
    kernel reads and writes the leaf in place; otherwise the leaf is padded
    into tiles first.  A CPU tensor goes to the plain version."""
    if flat.dim() != 2:
        raise ValueError(f"expected (m, d), got shape {tuple(flat.shape)}")
    if block % 128 != 0:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    if flat.dtype not in _ENTRY:
        raise TypeError(f"block top-k takes float32 or bfloat16, got {flat.dtype}")
    m, d = flat.shape
    nb = -(-d // block)
    if flat.device.type == "cuda" and d % 4 == 0 and flat.is_contiguous() and flat.data_ptr() % 16 == 0:
        _check_launch(flat, block, k)
        out = torch.empty_like(flat)
        if out.numel():
            _launch(_LEAF_ENTRY[flat.dtype], flat, out, m * nb, block, k, d)
        return out
    tiles = F.pad(flat, (0, nb * block - d)).reshape(m * nb, block)
    return block_topk_kernel(tiles, k).reshape(m, nb * block)[:, :d]
