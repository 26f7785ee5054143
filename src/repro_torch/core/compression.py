"""Contractive compressors (paper Definition 2) and analytic wire-byte
estimates (``repro.core.compression``'s counterpart).

A compressor ``Q`` must satisfy  E||Q(A) - A||^2 <= (1 - delta) ||A||^2  for
some delta in (0, 1].  Biased compressors are made contractive-compatible via
the paper's Proposition 1 rescaling  Q' = Q / (2 - delta)  (``Rescaled``).
``Q(x, generator)`` compresses ONE node's leaf; ``Q.compress_nodes(x,
generator)`` compresses every node's copy of a node-stacked leaf (each node
on its own, as the reference's vmap does), in one batched call.

Random sources
--------------
The stochastic compressors (RandK, StochasticQuant, KernelQuant, and
Rescaled around one of them) draw from an explicit random source, where the
reference passes keys.  ``generator`` is a ``torch.Generator`` on the run's
device (wrapped by ``TorchSource``) or any object with two methods:

* ``uniform(shape, device, dtype=torch.float32)``: samples in [0, 1) of
  ``dtype`` (KernelQuant draws in its leaf's dtype, as the reference's
  ``jax.random.uniform(key, shape, x.dtype)``; a bf16 draw is not an f32
  draw rounded down);
* ``choice(n, k, device)``: k distinct indices of range(n), as
  ``jax.random.choice(..., replace=False)`` gives them.

A stochastic compressor given ``generator=None`` raises a ValueError that
names it (the reference's ``run`` requires a key).  The deterministic
compressors ignore the source.

Draw order.  The port draws in the order of the reference's key tree, so a
test can walk that tree and replay the reference's draws:

    rounds             in order
    within a round     the y loop, then the z loop
    within a loop      the K steps in order
    within a step      q_d, then q_s
    within a message   leaves in sorted-key order
    within a leaf      one draw per ``compress_nodes`` call, node-major

The one draw of a leaf is ``uniform((m * nb, block))`` in the leaf's dtype
for KernelQuant, ``uniform((m, d))`` for StochasticQuant, and m calls to
``choice(d, k)`` for RandK (d: one node's flat leaf size).

``leaf_wire_bytes`` is the analytic float estimate; ``repro_torch.net.wire``
serializes the real payloads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.core.types import Tree, tree_leaves, tree_map
from repro_torch.kernels.ops import block_topk_nodes, quantize_nodes
from repro_torch.kernels.ref import quantize_ref

VALUE_BYTES = 4  # float32 payload
INDEX_BYTES = 4  # int32 index payload


class TorchSource:
    """The random source of a ``torch.Generator``: samples are drawn on the
    generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape, device, dtype=torch.float32) -> torch.Tensor:
        return torch.rand(shape, dtype=dtype, generator=self.generator, device=self.generator.device).to(device)

    def choice(self, n: int, k: int, device) -> torch.Tensor:
        perm = torch.randperm(n, generator=self.generator, device=self.generator.device)
        return perm[:k].to(device)


def random_source(generator, who: Any):
    """``generator`` as a random source; ``who`` (the compressor that draws)
    names the ValueError raised when there is none."""
    if generator is None:
        raise ValueError(
            f"{who!r} is stochastic and needs a random source: pass generator= "
            "(a torch.Generator on the run's device, or an object with "
            "uniform(shape, device, dtype) and choice(n, k, device))"
        )
    if isinstance(generator, torch.Generator):
        return TorchSource(generator)
    return generator


class Compressor:
    """Interface.  ``delta`` is the contraction factor delta_c."""

    delta: float

    def __call__(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.compress_nodes(x.unsqueeze(0), generator).squeeze(0)

    def compress_nodes(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """Q applied to each node's copy of a node-stacked leaf."""
        raise NotImplementedError

    def leaf_wire_bytes(self, size: int) -> float:
        raise NotImplementedError

    # -- tree conveniences --------------------------------------------------
    def compress_tree(self, tree: Tree, generator=None) -> Tree:
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

    def compress_nodes(self, x, generator=None):
        return block_topk_nodes(x, ratio=self.ratio, block=self.block)

    def leaf_wire_bytes(self, size):
        nb = -(-size // self.block)
        k = max(1, int(round(self.ratio * self.block)))
        return nb * k * (VALUE_BYTES + INDEX_BYTES)


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Uniformly random k coordinates, unbiased when rescaled by d/k.

    The *biased* (unscaled) form, contractive with delta = ratio.  Draws m
    ``choice(d, k)`` a leaf, one a node.
    """

    ratio: float = 0.2

    @property
    def delta(self):  # type: ignore[override]
        return self.ratio

    def _k(self, d: int) -> int:
        return max(1, int(round(self.ratio * d)))

    def compress_nodes(self, x, generator=None):
        source = random_source(generator, self)
        m = x.shape[0]
        flat = x.reshape(m, -1)
        d = flat.shape[1]
        mask = torch.zeros_like(flat)
        for i in range(m):
            mask[i, source.choice(d, self._k(d), flat.device)] = 1.0
        return (flat * mask).reshape(x.shape)

    def leaf_wire_bytes(self, size):
        return self._k(size) * (VALUE_BYTES + INDEX_BYTES)


def _levels(bits: int) -> int:
    return (1 << bits) - 1


@dataclasses.dataclass(frozen=True)
class StochasticQuant(Compressor):
    """Per-leaf-scaled stochastic uniform quantizer to ``bits`` bits.

    Unbiased; one scale for each node's whole leaf, so it is the plain
    quantizer ``quantize_ref`` with one row a node.  Draws one
    ``uniform((m, d))`` a leaf.
    """

    bits: int = 4

    @property
    def delta(self):  # type: ignore[override]
        # levels L = 2^bits - 1; worst-case relative error 1/(2L) per entry
        return max(1e-3, 1.0 - 1.0 / (2 * _levels(self.bits)))

    def compress_nodes(self, x, generator=None):
        source = random_source(generator, self)
        flat = x.reshape(x.shape[0], -1)
        u = source.uniform(tuple(flat.shape), flat.device)
        return quantize_ref(flat, u, self.bits)[0].reshape(x.shape)

    def leaf_wire_bytes(self, size):
        return size * self.bits / 8.0 + VALUE_BYTES  # payload + scale


def _default_test_matrix(cols: int, rank: int) -> torch.Tensor:
    return torch.randn((cols, rank), generator=torch.Generator().manual_seed(0))


@dataclasses.dataclass(frozen=True)
class LowRank(Compressor):
    """PowerSGD-style rank-r residual sketch (beyond-paper compressor).

    Reshape the leaf to ~square (n, cols), one power iteration with a fixed
    random test matrix:  P = M Q0 (orthonormalized),  Q = M^T P,
    Q(M) = P Q^T.  Biased; delta below is the conservative bound used for
    wire accounting.  The reference fixes Q0 with ``jax.random.normal(
    PRNGKey(0), (cols, r))``, which torch cannot reproduce; here
    ``test_matrix(cols, r)`` makes it (by default from a CPU
    ``torch.Generator`` seeded with 0), and a test may pass the reference's.
    P Q^T = P P^T M does not depend on the QR's column signs.
    """

    rank: int = 4
    test_matrix: Callable[[int, int], torch.Tensor] = dataclasses.field(
        default=_default_test_matrix, compare=False, repr=False
    )

    @property
    def delta(self):  # type: ignore[override]
        return 1e-3  # conservative; see class docstring

    def _dims(self, d):
        n = math.isqrt(d)
        while d % n:
            n -= 1
        return n, d // n

    def _worth_it(self, d):
        n, cols = self._dims(d)
        r = min(self.rank, n, cols)
        return r * (n + cols) < d  # sketch must beat dense

    def compress_nodes(self, x, generator=None):
        m = x.shape[0]
        d = x[0].numel()
        if not self._worth_it(d):
            return x  # skinny/small leaf — send dense
        n, cols = self._dims(d)
        M = x.reshape(m, n, cols).to(torch.float32)
        r = min(self.rank, n, cols)
        q0 = self.test_matrix(cols, r).to(device=M.device, dtype=torch.float32)
        p, _ = torch.linalg.qr(M @ q0)
        q = M.transpose(1, 2) @ p
        out = p @ q.transpose(1, 2)
        return out.to(x.dtype).reshape(x.shape)

    def leaf_wire_bytes(self, size):
        if not self._worth_it(size):
            return size * VALUE_BYTES
        n, cols = self._dims(size)
        r = min(self.rank, n, cols)
        return r * (n + cols) * VALUE_BYTES


@dataclasses.dataclass(frozen=True)
class Rescaled(Compressor):
    """Proposition 1:  for an UNBIASED contractive Q,  Q' = Q / (2 - delta)
    is a (biased) contractive compressor with delta' = 1/(2 - delta)."""

    inner: Any = None

    @property
    def delta(self):  # type: ignore[override]
        return 1.0 / (2.0 - self.inner.delta)

    def compress_nodes(self, x, generator=None):
        return self.inner.compress_nodes(x, generator) / (2.0 - self.inner.delta)

    def leaf_wire_bytes(self, size):
        return self.inner.leaf_wire_bytes(size)


@dataclasses.dataclass(frozen=True)
class KernelQuant(Compressor):
    """StochasticQuant backed by the hand-written quantizer kernel, with
    per-block scales.  Every node's blocks of a leaf go to one launch, on
    one ``uniform((m * nb, block))`` draw in the leaf's dtype (f32 or
    bf16)."""

    bits: int = 4
    block: int = 1024

    @property
    def delta(self):  # type: ignore[override]
        return max(1e-3, 1.0 - 1.0 / (2 * _levels(self.bits)))

    def compress_nodes(self, x, generator=None):
        source = random_source(generator, self)
        m = x.shape[0]
        nb = -(-x[0].numel() // self.block)
        u = source.uniform((m * nb, self.block), x.device, dtype=x.dtype)
        return quantize_nodes(x, u, bits=self.bits, block=self.block)

    def leaf_wire_bytes(self, size):
        nb = -(-size // self.block)
        return size * self.bits / 8.0 + nb * VALUE_BYTES


_REGISTRY = {
    "identity": lambda **kw: Identity(),
    "topk": lambda **kw: TopK(ratio=kw.get("ratio", 0.2)),
    "block_topk": lambda **kw: BlockTopK(
        ratio=kw.get("ratio", 0.2), block=kw.get("block", 1024)
    ),
    "randk": lambda **kw: RandK(ratio=kw.get("ratio", 0.2)),
    "quant": lambda **kw: StochasticQuant(bits=kw.get("bits", 4)),
    "kernel_topk": lambda **kw: KernelBlockTopK(
        ratio=kw.get("ratio", 0.2), block=kw.get("block", 1024)
    ),
    "kernel_quant": lambda **kw: KernelQuant(
        bits=kw.get("bits", 4), block=kw.get("block", 1024)
    ),
    "lowrank": lambda **kw: LowRank(rank=kw.get("rank", 4)),
}


def make_compressor(name: str, **kwargs) -> Compressor:
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def empirical_contraction(compressor: Compressor, generator, x: torch.Tensor) -> torch.Tensor:
    """Return ||Q(x) - x||^2 / ||x||^2 — must be <= 1 - delta (in expectation
    for randomized Q).  Used by property tests."""
    qx = compressor(x, generator)
    num = torch.sum((qx - x) ** 2)
    den = torch.clamp_min(torch.sum(x**2), 1e-30)
    return num / den
