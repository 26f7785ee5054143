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

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_topk_ref

MAX_BLOCK = 4096  # 256 threads x 16 values a thread, held in registers
_ENTRY = {torch.float32: "block_topk_f32", torch.bfloat16: "block_topk_bf16"}


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
    if x2d.device.type != "cuda":
        raise ValueError(f"block top-k runs on cpu or cuda, got {x2d.device}")
    if block > MAX_BLOCK:
        raise ValueError(f"the kernel holds a row in registers: block <= {MAX_BLOCK}")
    if not 1 <= k <= block:
        raise ValueError(f"k must lie in [1, {block}], got {k}")
    if not x2d.is_contiguous():
        raise ValueError("block top-k needs a contiguous input")
    out = torch.empty_like(x2d)
    if nb == 0:
        return out
    fn = getattr(_build.library("topk_compress"), _ENTRY[x2d.dtype])
    stream = _build.stream_for(x2d)
    rc = fn(x2d.data_ptr(), out.data_ptr(), nb, block, int(k), stream)
    _build.check(rc, "block_topk")
    _build.LAUNCHES["block_topk"] += 1
    return out
