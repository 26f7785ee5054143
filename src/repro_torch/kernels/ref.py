"""Plain PyTorch versions of the compression kernels (``repro.kernels.ref``'s
``block_topk_ref`` and ``quantize_ref``).

They define the EXACT semantics the CUDA kernels in ``csrc/topk_compress.cu``
and ``csrc/quantize.cu`` reproduce bit for bit.  The top-k bisection runs in
the input dtype: for bf16 input, ``lo + hi`` and ``mid`` are rounded to bf16
every round, as the reference computes.  The quantizer is computed op by
op, each op rounding once to the input dtype (f32 or bf16), as the
reference's jnp oracle is.
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


def quantize_ref(
    x2d: torch.Tensor, u2d: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row-scaled stochastic uniform quantization.

    u2d are iid U[0,1) samples (same shape as x2d).  Returns the dequantized
    array plus the (nb, 1) per-row scales (what a deployment would transmit
    along with the packed codes).  A row holding NaN has a NaN scale and
    comes out all NaN, as ``jnp.max`` propagates it.
    """
    # a tensor on x's device, so CUDA divides by it (it multiplies by the
    # reciprocal of a host scalar, which rounds differently)
    levels = torch.tensor((1 << bits) - 1, dtype=x2d.dtype, device=x2d.device)
    floor = torch.tensor(1e-12, dtype=x2d.dtype, device=x2d.device)
    scale = torch.maximum(torch.amax(torch.abs(x2d), dim=-1, keepdim=True), floor)
    y = x2d / scale  # [-1, 1]
    steps = (y + 1.0) * 0.5 * levels
    lo = torch.floor(steps)
    q = lo + (u2d < (steps - lo)).to(x2d.dtype)
    deq = (q / levels) * 2.0 - 1.0
    return deq * scale, scale
