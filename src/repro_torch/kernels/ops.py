"""Public wrappers over the compression kernels (``repro.kernels.ops``'s
counterpart).

Blocks are cut PER NODE, as the reference cuts them (it vmaps the
compressor over the node axis and pads each node's flat leaf on its own),
and every node's blocks of a leaf go to ONE launch of m * nb rows: no block
ever straddles two nodes.  Both kernels read the (m, d) leaf in place
where d % 4 == 0; the quantizer's samples lie in the (m * nb, block) tile
layout of their draw.

A meta tensor (the cost meter's count of a round body,
`repro_torch.obs.compute.meta_cost`: shapes only, nothing executes) goes to
the plain version on zero-padded tiles, which computes its shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import quantize_leaf
from repro_torch.kernels.ref import block_topk_ref, quantize_ref
from repro_torch.kernels.topk_compress import block_topk_leaf


def _plain_on_tiles(flat: torch.Tensor, block: int, fn) -> torch.Tensor:
    """``fn`` on the (m * nb, block) zero-padded tiles of an (m, d) leaf, cut
    back to (m, d)."""
    m, d = flat.shape
    nb = -(-d // block)
    return fn(F.pad(flat, (0, nb * block - d)).reshape(m * nb, block)).reshape(m, nb * block)[:, :d]


def block_topk_nodes(x: torch.Tensor, ratio: float = 0.2, block: int = 1024) -> torch.Tensor:
    """Kernel-backed block top-k of every node's copy of a node-stacked leaf
    (one launch, which reads the leaf in place where it can)."""
    k = max(1, int(round(ratio * block)))
    flat = x.reshape(x.shape[0], -1)
    if flat.is_meta:
        return _plain_on_tiles(flat, block, lambda t: block_topk_ref(t, k)).reshape(x.shape)
    return block_topk_leaf(flat, k, block).reshape(x.shape)


def block_topk(x: torch.Tensor, ratio: float = 0.2, block: int = 1024) -> torch.Tensor:
    """Kernel-backed contractive block top-k compressor (any input shape)."""
    return block_topk_nodes(x.unsqueeze(0), ratio, block).squeeze(0)


def quantize_nodes(x: torch.Tensor, u: torch.Tensor, bits: int = 4, block: int = 1024) -> torch.Tensor:
    """Kernel-backed stochastic quantizer of every node's copy of a
    node-stacked leaf (dequantized output), one launch that reads the leaf in
    place where it can.  ``u`` holds the U[0,1) samples of the (m * nb,
    block) zero-padded tiles, node-major.  The padded tail of a node's last
    block would quantize to nonzero grid points (2^bits - 1 levels put no
    point on zero); it is never written, as the reference slices it off."""
    flat = x.reshape(x.shape[0], -1)
    if flat.is_meta:
        return _plain_on_tiles(flat, block, lambda t: quantize_ref(t, u, bits)[0]).reshape(x.shape)
    return quantize_leaf(flat, u, bits, block).reshape(x.shape)


def quantize(x: torch.Tensor, u: torch.Tensor, bits: int = 4, block: int = 1024) -> torch.Tensor:
    """Kernel-backed stochastic quantizer of one leaf (any input shape);
    ``u`` holds the samples of its (nb, block) tiles."""
    return quantize_nodes(x.unsqueeze(0), u, bits, block).squeeze(0)
