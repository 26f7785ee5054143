"""Public wrappers over the compression kernels (``repro.kernels.ops``'s
counterpart).

Blocks are cut PER NODE, as the reference cuts them (it vmaps the
compressor over the node axis and pads each node's flat leaf on its own),
and every node's blocks of a leaf go to ONE launch of m * nb rows: no block
ever straddles two nodes.  The quantizer sees (m * nb, block) zero-padded
tiles; block top-k reads the (m, d) leaf in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import quantize_kernel
from repro_torch.kernels.topk_compress import block_topk_leaf


def to_blocks(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    """Node-stacked (m, ...) -> ((m * nb, block) zero-padded tiles, d), where
    d is the flat size of one node's leaf."""
    m = x.shape[0]
    flat = x.reshape(m, -1)
    d = flat.shape[1]
    nb = -(-d // block)
    padded = F.pad(flat, (0, nb * block - d))
    return padded.reshape(m * nb, block), d


def from_blocks(tiles: torch.Tensor, d: int, like: torch.Tensor) -> torch.Tensor:
    m = like.shape[0]
    return tiles.reshape(m, -1)[:, :d].reshape(like.shape)


def block_topk_nodes(x: torch.Tensor, ratio: float = 0.2, block: int = 1024) -> torch.Tensor:
    """Kernel-backed block top-k of every node's copy of a node-stacked leaf
    (one launch, which reads the leaf in place where it can)."""
    k = max(1, int(round(ratio * block)))
    return block_topk_leaf(x.reshape(x.shape[0], -1), k, block).reshape(x.shape)


def block_topk(x: torch.Tensor, ratio: float = 0.2, block: int = 1024) -> torch.Tensor:
    """Kernel-backed contractive block top-k compressor (any input shape)."""
    return block_topk_nodes(x.unsqueeze(0), ratio, block).squeeze(0)


def quantize_nodes(x: torch.Tensor, u: torch.Tensor, bits: int = 4, block: int = 1024) -> torch.Tensor:
    """Kernel-backed stochastic quantizer of every node's copy of a
    node-stacked leaf (dequantized output).  ``u`` holds the U[0,1) samples
    of the (m * nb, block) tiles, node-major.  The zero-padded tail of a
    node's last block quantizes to nonzero grid points (2^bits - 1 levels
    put no point on zero); ``from_blocks`` slices it off, as the reference
    does."""
    tiles, d = to_blocks(x, block)
    out, _ = quantize_kernel(tiles, u, bits)
    return from_blocks(out, d, x)


def quantize(x: torch.Tensor, u: torch.Tensor, bits: int = 4, block: int = 1024) -> torch.Tensor:
    """Kernel-backed stochastic quantizer of one leaf (any input shape);
    ``u`` holds the samples of its (nb, block) tiles."""
    return quantize_nodes(x.unsqueeze(0), u, bits, block).squeeze(0)
