"""Top-k selections of one run recorded, and imposed on another run of the
same round, with every parting checked to be a near-tie.

Two runs of the same round that sum in different orders (the dense mix
``W @ hat - hat`` against the device exchange's shift-by-shift sums)
compress residuals that differ by rounding.  Where a row's k-th and
(k+1)-th magnitudes lie that close, the two top-k selections may keep
different coordinates, and the runs drift apart from there: a free
comparison cannot tell such a parting from a fault.  So the comparison is
made round by round: `recorded` keeps each compression's residual rows
and kept mask in one run, and `imposed` makes the other run keep those
coordinates, after checking that wherever its own choice differs the
parting is one that rounding decides.  Where one run cannot follow the
other's selections for long (a trajectory that amplifies rounding, so the
residuals drift apart even on the same coordinates), `compared` lets the
second run choose for itself and finds the first parting, which must be a
near-tie: the two runs agree up to it.

The near-tie test of a parted row, with ``a`` the imposing run's residual
row, ``b`` the recorded one and ``delta = max |a - b|``: the two
selections' thresholds lie within ``delta + step_a + step_b`` of each
other.  A top-k selection keeps the magnitudes at or above a threshold:
the k-th largest magnitude for an exact top-k (`TopK`, `BlockTopK`,
``step`` 0), the bisection's ``lo`` for `KernelBlockTopK`, which lies
below the k-th magnitude by less than its resolution ``step`` (the row's
maximum times the dtype's machine epsilon: 24 halvings of [0, max] reach
2^-24 of it, and ``mid`` rounds to the dtype).  The k-th magnitudes of
two rows differ by at most ``delta``, so two thresholds farther apart
are not rounding; and every coordinate one selection keeps and the other
drops lies between the thresholds, within ``delta`` of both, so the
parted magnitudes lie within twice ``delta`` (plus the steps) of each
other.

Rows are what the compressor selects within: one a node for `TopK`, the
zero-padded (m * nb, block) tiles for the block compressors.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import compression as C
from repro_torch.kernels.ref import BISECT_ITERS

SELECTORS = (C.TopK, C.BlockTopK, C.KernelBlockTopK)
RTOL, ATOL = 1e-4, 1e-6  # the golden tolerance, which `compared` holds residuals to before their runs part


def _rows(comp, x: torch.Tensor) -> torch.Tensor:
    """The rows ``comp`` selects within, of a node-stacked leaf."""
    flat = x.reshape(x.shape[0], -1)
    if isinstance(comp, C.TopK):
        return flat
    d = flat.shape[1]
    nb = -(-d // comp.block)
    return F.pad(flat, (0, nb * comp.block - d)).reshape(-1, comp.block)


def _step(comp, rows: torch.Tensor) -> torch.Tensor:
    """Per row, the resolution of ``comp``'s threshold (0 for an exact top-k)."""
    if not isinstance(comp, C.KernelBlockTopK):
        return torch.zeros(rows.shape[0], device=rows.device)
    hi = torch.amax(torch.abs(rows.float()), dim=-1)
    return hi * torch.finfo(rows.dtype).eps


@contextlib.contextmanager
def _patched(wrap):
    """Every selector's ``compress_nodes`` replaced by ``wrap(original)``."""
    saved = {cls: cls.compress_nodes for cls in SELECTORS}
    try:
        for cls, fn in saved.items():
            cls.compress_nodes = wrap(fn)
        yield
    finally:
        for cls, fn in saved.items():
            cls.compress_nodes = fn


@contextlib.contextmanager
def recorded(log: list):
    """Within the block, every top-k compression appends ``(rows, kept)``
    to ``log``: its residual's rows and the mask of the coordinates it
    kept (its nonzero outputs), both on the run's device."""

    def wrap(fn):
        def compress_nodes(self, x, generator=None):
            out = fn(self, x, generator)
            if not x.is_meta:  # the cost meter's count holds no values
                log.append((_rows(self, x).clone(), _rows(self, out) != 0))
            return out

        return compress_nodes

    with _patched(wrap):
        yield log


@dataclasses.dataclass
class Partings:
    """What `imposed` (or `compared`) saw: the compressions it imposed (or
    compared), the rows whose own choice differed (all near-ties, or it
    raised), the largest relative gap between a parted row's k-th and
    (k+1)-th magnitudes (``rel_gap``), the largest gap between two
    thresholds as a share of its allowance (``of_allowance``: at most 1 by
    the check) and the index of the first compression whose choice
    differed (``first``; None while none has)."""

    compressions: int = 0
    rows: int = 0
    rel_gap: float = 0.0
    of_allowance: float = 0.0
    first: int | None = None


def _threshold(comp, rows: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the magnitude at or above which ``comp`` keeps a coordinate:
    the k-th largest for an exact top-k, the bisection's ``lo`` (computed
    in the rows' dtype, as `repro_torch.kernels.ref.block_topk_ref` does)
    for `KernelBlockTopK`; in f32."""
    ax = torch.abs(rows)
    if not isinstance(comp, C.KernelBlockTopK):
        return torch.topk(ax, k, dim=-1).values[:, -1].float()
    hi = torch.amax(ax, dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        take = torch.sum(ax >= mid, dim=-1, keepdim=True) >= k
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    return lo[:, 0].float()


def _k(comp, rows: torch.Tensor) -> int:
    if isinstance(comp, C.TopK):
        return comp._k(rows.shape[1])
    return max(1, int(round(comp.ratio * comp.block)))


def _rel_margin(rows: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the relative gap between the k-th and the (k+1)-th
    magnitude: how near a tie the selection's boundary is (inf where the
    k-th is 0 or there is no (k+1)-th)."""
    if k >= rows.shape[1]:
        return torch.full((rows.shape[0],), torch.inf, device=rows.device)
    a = torch.topk(torch.abs(rows.float()), k + 1, dim=-1).values
    kth, nxt = a[:, k - 1], a[:, k]
    return torch.where(kth > 0, (kth - nxt) / torch.where(kth > 0, kth, 1.0), torch.inf)


def _check_close(rows: torch.Tensor, ref: torch.Tensor, index: int) -> None:
    """Raise unless every row of the residual lies within the golden
    tolerance of its recorded row's largest magnitude."""
    scale = torch.amax(torch.abs(ref.float()), dim=-1)
    drift = torch.amax(torch.abs(rows.float() - ref.float()), dim=-1)
    bad = drift > ATOL + RTOL * scale
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        raise AssertionError(f"compression {index}, row {i}: the residuals differ by {float(drift[i])!r} before "
                             f"the runs part, beyond the golden tolerance of a row of scale {float(scale[i])!r}")


def _check_parted(comp, rows: torch.Tensor, ref: torch.Tensor, want: torch.Tensor, own: torch.Tensor,
                  seen: Partings) -> None:
    """Count compression ``seen.compressions`` (its residual ``rows``, the
    recorded ``ref`` and ``want``, its own choice ``own``) in ``seen``;
    raise unless every row whose choice differs is a near-tie."""
    if ref.shape != rows.shape:
        raise AssertionError(f"compression {seen.compressions}: rows {tuple(rows.shape)}, recorded "
                             f"{tuple(ref.shape)}: the two runs compress different leaves")
    seen.compressions += 1
    parted = (own != want).any(dim=-1)
    if not bool(parted.any()):
        return
    r = torch.nonzero(parted).flatten()
    a, b, k = rows[r], ref[r], _k(comp, rows)
    delta = torch.amax(torch.abs(a.float() - b.float()), dim=-1)
    allow = delta + _step(comp, a) + _step(comp, b)
    gap = torch.abs(_threshold(comp, a, k) - _threshold(comp, b, k))
    bad = gap > allow
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        raise AssertionError(
            f"compression {seen.compressions - 1}, row {int(r[i])}: the selections part off a "
            f"near-tie: their thresholds differ by {float(gap[i])!r}, the residuals by "
            f"{float(delta[i])!r} (allowance with the thresholds' steps {float(allow[i])!r})"
        )
    seen.rows += int(r.numel())
    seen.rel_gap = max(seen.rel_gap, float(_rel_margin(a, k).max()))
    seen.of_allowance = max(seen.of_allowance, float(torch.where(allow > 0, gap / allow, 0.0).max()))
    if seen.first is None:
        seen.first = seen.compressions - 1


@contextlib.contextmanager
def imposed(log, partings: Partings | None = None):
    """Within the block, each top-k compression keeps the coordinates of the
    next ``(rows, kept)`` of ``log`` (a `recorded` log, consumed in order;
    once it is empty the compressions choose for themselves).  Where the
    compression's own choice of a row differs, the row must be a near-tie
    (see the module docstring), or this raises an AssertionError naming
    the row, its margin and its allowance.  ``partings`` (a `Partings`)
    collects the counts."""
    queue = collections.deque(log)
    seen = partings if partings is not None else Partings()

    def wrap(fn):
        def compress_nodes(self, x, generator=None):
            own_out = fn(self, x, generator)
            if x.is_meta or not queue:
                return own_out
            ref, want = queue.popleft()
            _check_parted(self, _rows(self, x), ref, want, _rows(self, own_out) != 0, seen)
            flat = x.reshape(x.shape[0], -1)
            mask = want.reshape(flat.shape[0], -1)[:, : flat.shape[1]]
            return (flat * mask.to(flat.dtype)).reshape(x.shape)

        return compress_nodes

    with _patched(wrap):
        yield seen
    if queue:
        raise AssertionError(f"{len(queue)} recorded compressions were never made: the runs compress differently")


@contextlib.contextmanager
def compared(log, partings: Partings | None = None):
    """Within the block, each top-k compression chooses for itself and is
    compared with the next ``(rows, kept)`` of ``log`` (consumed in order).
    Up to and including the first whose choice of a row differs, every
    residual must agree with the recorded one within the golden tolerance
    of its row's largest magnitude (rtol ``RTOL``, atol ``ATOL``), which is
    what makes that parting a rounding near-tie and not a fault, and the
    parting must pass `imposed`'s near-tie test; otherwise this raises.
    From that compression on the two runs are apart, so later ones are
    only counted (``partings.first`` says where; None if the runs never
    part).  Both runs must make the same number of compressions."""
    queue = collections.deque(log)
    seen = partings if partings is not None else Partings()

    def wrap(fn):
        def compress_nodes(self, x, generator=None):
            own_out = fn(self, x, generator)
            if x.is_meta:
                return own_out
            if not queue:
                raise AssertionError("this run compresses more often than the recorded one")
            ref, want = queue.popleft()
            if seen.first is None:
                rows = _rows(self, x)
                _check_parted(self, rows, ref, want, _rows(self, own_out) != 0, seen)
                _check_close(rows, ref, seen.compressions - 1)
            else:
                seen.compressions += 1
            return own_out

        return compress_nodes

    with _patched(wrap):
        yield seen
    if queue:
        raise AssertionError(f"{len(queue)} recorded compressions were never made: the runs compress differently")
