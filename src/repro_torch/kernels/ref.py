"""Plain PyTorch version of the block top-k kernel (``repro.kernels.ref``'s
``block_topk_ref``).

It defines the EXACT semantics the CUDA kernel in ``csrc/topk_compress.cu``
reproduces bit for bit, including the threshold-bisection selection rule.
The bisection runs in the input dtype: for bf16 input, ``lo + hi`` and
``mid`` are rounded to bf16 every round, as the reference computes.
"""

from __future__ import annotations

import torch

BISECT_ITERS = 24


def block_topk_ref(x2d: torch.Tensor, k: int) -> torch.Tensor:
    """Threshold-bisection block top-k on a (nb, block) array.

    For each row, find by bisection the largest threshold theta such that
    count(|x| >= theta) >= k, then keep entries with |x| >= theta.
    With exact arithmetic this keeps exactly k entries (up to ties); the
    fixed iteration count makes it deterministic (reductions + masks only,
    no sort).  Dropped entries are ``x * 0`` (so dropped negatives are -0.0).
    """
    ax = torch.abs(x2d)
    hi = torch.amax(ax, dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum(ax >= mid, dim=-1, keepdim=True)
        # if we keep >= k at mid, the true threshold is >= mid
        take = cnt >= k
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    mask = ax >= lo
    return x2d * mask.to(x2d.dtype)
