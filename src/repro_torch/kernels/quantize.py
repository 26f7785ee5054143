"""Per-row-scaled stochastic uniform quantization: the wrapper of the CUDA
kernel in ``csrc/quantize.cu``, which replaces the Pallas kernel
``repro.kernels.quantize.quantize_pallas``.

One scale per compression block (row); codes are b-bit grid points chosen
by stochastic rounding.  The kernel emits the dequantized tensor (what the
receiving node reconstructs) and the per-row scales (what goes on the wire
next to the packed codes).  The U[0,1) samples are passed IN, as in the
reference, so the plain version (``repro_torch.kernels.ref.quantize_ref``)
and the kernel agree bit for bit on the same samples.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_ref

_ENTRY = {torch.float32: "quantize_f32", torch.bfloat16: "quantize_bf16"}
_COUNTER = {torch.float32: "quantize", torch.bfloat16: "quantize_bf16"}


def quantize_kernel(
    x2d: torch.Tensor, u2d: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """x2d, u2d: (nb, block) residual blocks and their U[0,1) samples, both
    f32 or both bf16, block a multiple of 128, bits in 1..8.  Returns
    ``(out, scales)`` in that dtype, scales of shape (nb, 1).  CPU tensors go
    to the plain version; CUDA tensors to the kernel (or the call raises)."""
    if x2d.dim() != 2:
        raise ValueError(f"expected (nb, block), got shape {tuple(x2d.shape)}")
    if u2d.shape != x2d.shape:
        raise ValueError(f"samples of shape {tuple(u2d.shape)} for blocks of shape {tuple(x2d.shape)}")
    nb, block = x2d.shape
    if block % 128 != 0:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    if x2d.dtype not in _ENTRY or u2d.dtype != x2d.dtype:
        raise TypeError(
            f"the quantizer takes float32 or bfloat16 blocks and samples of one dtype, got {x2d.dtype} and {u2d.dtype}"
        )
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must lie in 1..8, got {bits}")
    if x2d.device != u2d.device:
        raise ValueError(f"blocks on {x2d.device}, samples on {u2d.device}")
    if x2d.device.type == "cpu":
        return quantize_ref(x2d, u2d, bits)
    if x2d.device.type != "cuda":
        raise ValueError(f"the quantizer runs on cpu or cuda, got {x2d.device}")
    if not (x2d.is_contiguous() and u2d.is_contiguous()):
        raise ValueError("the quantizer needs contiguous blocks and samples")
    align = 4 * x2d.element_size()  # four values a load
    if x2d.data_ptr() % align or u2d.data_ptr() % align:
        raise ValueError(f"the quantizer reads four values a load: inputs must be {align}-byte aligned")
    out = torch.empty_like(x2d)
    scales = torch.empty((nb, 1), dtype=x2d.dtype, device=x2d.device)
    if nb == 0:
        return out, scales
    fn = getattr(_build.library("quantize"), _ENTRY[x2d.dtype])
    stream = _build.stream_for(x2d)
    rc = fn(x2d.data_ptr(), u2d.data_ptr(), out.data_ptr(), scales.data_ptr(), nb, block, int(bits), stream)
    _build.check(rc, "quantize")
    _build.LAUNCHES[_COUNTER[x2d.dtype]] += 1
    return out, scales
