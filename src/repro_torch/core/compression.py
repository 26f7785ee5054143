"""Contractive compressors (paper Definition 2) and analytic wire-byte
estimates (``repro.core.compression``'s counterpart).

A compressor ``Q`` must satisfy  E||Q(A) - A||^2 <= (1 - delta) ||A||^2  for
some delta in (0, 1].  ``Q(x, generator)`` compresses ONE node's leaf;
``Q.compress_nodes(x, generator)`` compresses every node's copy of a
node-stacked leaf (each node on its own, as the reference's vmap does), in
one batched call where the compressor has one.  The compressors of this
module are deterministic and ignore the generator.

``leaf_wire_bytes`` is the analytic float estimate; ``repro_torch.net.wire``
serializes the real payloads.  RandK, StochasticQuant, LowRank, Rescaled and
KernelQuant are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.types import Tree, tree_leaves, tree_map
from repro_torch.kernels.ops import block_topk, block_topk_nodes

VALUE_BYTES = 4  # float32 payload
INDEX_BYTES = 4  # int32 index payload


class Compressor:
    """Interface.  ``delta`` is the contraction factor delta_c."""

    delta: float

    def __call__(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        raise NotImplementedError

    def compress_nodes(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Q applied to each node's copy of a node-stacked leaf."""
        return torch.stack([self(v, generator) for v in x])

    def leaf_wire_bytes(self, size: int) -> float:
        raise NotImplementedError

    # -- tree conveniences --------------------------------------------------
    def compress_tree(self, tree: Tree, generator: torch.Generator | None = None) -> Tree:
        return tree_map(lambda v: self(v, generator), tree)

    def tree_wire_bytes(self, tree: Tree) -> float:
        return float(sum(self.leaf_wire_bytes(int(x.numel())) for x in tree_leaves(tree)))


def _keep_topk(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Rows of ``flat`` masked to their k largest magnitudes (``x * mask``,
    so a dropped negative is -0.0 as in the reference)."""
    idx = torch.topk(torch.abs(flat), k, dim=-1).indices
    mask = torch.zeros_like(flat).scatter_(-1, idx, 1.0)
    return flat * mask


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """No compression (delta = 1)."""

    delta: float = 1.0

    def __call__(self, x, generator=None):
        return x

    def compress_nodes(self, x, generator=None):
        return x

    def leaf_wire_bytes(self, size):
        return size * VALUE_BYTES


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Exact global top-k by magnitude (the paper's experimental choice).

    ratio = k/d.  Biased; contractive with delta = ratio.
    """

    ratio: float = 0.2

    @property
    def delta(self):  # type: ignore[override]
        return self.ratio

    def _k(self, d: int) -> int:
        return max(1, int(round(self.ratio * d)))

    def __call__(self, x, generator=None):
        return self.compress_nodes(x.unsqueeze(0)).squeeze(0)

    def compress_nodes(self, x, generator=None):
        flat = x.reshape(x.shape[0], -1)
        return _keep_topk(flat, self._k(flat.shape[1])).reshape(x.shape)

    def leaf_wire_bytes(self, size):
        return self._k(size) * (VALUE_BYTES + INDEX_BYTES)


@dataclasses.dataclass(frozen=True)
class BlockTopK(Compressor):
    """Per-block top-k, exact selection (the semantic form of the kernel).

    Splits each node's flattened leaf into blocks of ``block`` and keeps the
    top round(ratio*block) entries of each block.  Contractive with
    delta = ratio.  ``KernelBlockTopK`` is the bisection-kernel variant.
    """

    ratio: float = 0.2
    block: int = 1024

    @property
    def delta(self):  # type: ignore[override]
        return self.ratio

    def __call__(self, x, generator=None):
        return self.compress_nodes(x.unsqueeze(0)).squeeze(0)

    def compress_nodes(self, x, generator=None):
        m = x.shape[0]
        flat = x.reshape(m, -1)
        d = flat.shape[1]
        nb = -(-d // self.block)
        padded = F.pad(flat, (0, nb * self.block - d)).reshape(m * nb, self.block)
        k = max(1, int(round(self.ratio * self.block)))
        out = _keep_topk(padded, k)
        return out.reshape(m, -1)[:, :d].reshape(x.shape)

    def leaf_wire_bytes(self, size):
        nb = -(-size // self.block)
        k = max(1, int(round(self.ratio * self.block)))
        # per-block local indices need only ceil(log2(block))/8 bytes; keep 4
        # for comparability with TopK.
        return nb * k * (VALUE_BYTES + INDEX_BYTES)


@dataclasses.dataclass(frozen=True)
class KernelBlockTopK(Compressor):
    """BlockTopK backed by the hand-written kernel (threshold-bisection
    selection, ``repro_torch.kernels.ref.block_topk_ref`` semantics); keeps
    ~k per block and is contractive with delta = ratio.  Every node's blocks
    of a leaf go to one kernel launch."""

    ratio: float = 0.2
    block: int = 1024

    @property
    def delta(self):  # type: ignore[override]
        return self.ratio

    def __call__(self, x, generator=None):
        return block_topk(x, ratio=self.ratio, block=self.block)

    def compress_nodes(self, x, generator=None):
        return block_topk_nodes(x, ratio=self.ratio, block=self.block)

    def leaf_wire_bytes(self, size):
        nb = -(-size // self.block)
        k = max(1, int(round(self.ratio * self.block)))
        return nb * k * (VALUE_BYTES + INDEX_BYTES)


_REGISTRY = {
    "identity": lambda **kw: Identity(),
    "topk": lambda **kw: TopK(ratio=kw.get("ratio", 0.2)),
    "block_topk": lambda **kw: BlockTopK(
        ratio=kw.get("ratio", 0.2), block=kw.get("block", 1024)
    ),
    "kernel_topk": lambda **kw: KernelBlockTopK(
        ratio=kw.get("ratio", 0.2), block=kw.get("block", 1024)
    ),
}


def make_compressor(name: str, **kwargs) -> Compressor:
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
