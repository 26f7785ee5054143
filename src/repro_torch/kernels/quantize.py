"""Per-row-scaled stochastic uniform quantization: the wrapper of the CUDA
kernel in ``csrc/quantize.cu``, which replaces the Pallas kernel
``repro.kernels.quantize.quantize_pallas``.

One scale per compression block (row); codes are b-bit grid points chosen
by stochastic rounding.  The kernel emits the dequantized tensor (what the
receiving node reconstructs) and, on tiles, the per-row scales (what goes
on the wire next to the packed codes).  The U[0,1) samples are passed IN,
as in the reference, so the plain version
(``repro_torch.kernels.ref.quantize_ref``) and the kernel agree bit for bit
on the same samples.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_ref

MAX_BLOCK = 4096  # above 1,024: one CTA of block / 4 threads a row, at most 1,024
_ENTRY = {torch.float32: "quantize_f32", torch.bfloat16: "quantize_bf16"}
_LEAF_ENTRY = {torch.float32: "quantize_leaf_f32", torch.bfloat16: "quantize_leaf_bf16"}
_COUNTER = {torch.float32: "quantize", torch.bfloat16: "quantize_bf16"}


def _check_args(x: torch.Tensor, u: torch.Tensor, block: int, bits: int) -> None:
    if block % 128 != 0:
        raise ValueError(f"block must be a multiple of 128, got {block}")
    if x.dtype not in _ENTRY or u.dtype != x.dtype:
        raise TypeError(
            f"the quantizer takes float32 or bfloat16 blocks and samples of one dtype, got {x.dtype} and {u.dtype}"
        )
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must lie in 1..8, got {bits}")
    if x.device != u.device:
        raise ValueError(f"blocks on {x.device}, samples on {u.device}")


def _check_launch(x: torch.Tensor, u: torch.Tensor, block: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the quantizer runs on cpu or cuda, got {x.device}")
    if block > MAX_BLOCK:
        raise ValueError(f"the kernel holds a row in registers: block <= {MAX_BLOCK}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("the quantizer needs contiguous blocks and samples")


def _launch(entry: str, x: torch.Tensor, *args: int) -> None:
    fn = getattr(_build.library("quantize"), entry)
    _build.check(fn(*args, _build.stream_for(x)), "quantize")
    _build.LAUNCHES[_COUNTER[x.dtype]] += 1


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
    _check_args(x2d, u2d, block, bits)
    if x2d.device.type == "cpu":
        return quantize_ref(x2d, u2d, bits)
    _check_launch(x2d, u2d, block)
    align = 4 * x2d.element_size()  # four values a load
    if x2d.data_ptr() % align or u2d.data_ptr() % align:
        raise ValueError(f"the quantizer reads four values a load: inputs must be {align}-byte aligned")
    out = torch.empty_like(x2d)
    scales = torch.empty((nb, 1), dtype=x2d.dtype, device=x2d.device)
    if nb:
        _launch(_ENTRY[x2d.dtype], x2d, x2d.data_ptr(), u2d.data_ptr(), out.data_ptr(), scales.data_ptr(),
                nb, block, int(bits))
    return out, scales


def quantize_leaf(flat: torch.Tensor, u: torch.Tensor, bits: int, block: int) -> torch.Tensor:
    """flat: (m, d) node-stacked flat leaf, f32 or bf16; u: the U[0,1)
    samples of its (m * ceil(d / block), block) zero-padded tiles, node-major,
    in the same dtype.  Returns the dequantized (m, d) leaf: the values of
    ``quantize_kernel`` on the padded tiles, cut back to (m, d) (the
    padding's codes are drawn and dropped, as the reference does).  On a
    CUDA tensor with d % 4 == 0, contiguous and 16-byte aligned, the kernel
    reads and writes the leaf in place; another CUDA leaf is padded into
    tiles first.  A CPU tensor goes to the plain version."""
    if flat.dim() != 2:
        raise ValueError(f"expected (m, d), got shape {tuple(flat.shape)}")
    m, d = flat.shape
    nb = -(-d // block)
    if tuple(u.shape) != (m * nb, block):
        raise ValueError(f"samples of shape {tuple(u.shape)} for a ({m}, {d}) leaf in blocks of {block}")
    _check_args(flat, u, block, bits)
    if flat.device.type == "cuda" and d % 4 == 0 and flat.is_contiguous() and flat.data_ptr() % 16 == 0:
        _check_launch(flat, u, block)
        if u.data_ptr() % 16:
            raise ValueError("the quantizer reads the samples four values a load: they must be 16-byte aligned")
        out = torch.empty_like(flat)
        if out.numel():
            _launch(_LEAF_ENTRY[flat.dtype], flat, flat.data_ptr(), u.data_ptr(), out.data_ptr(),
                    m * nb, block, d, int(bits))
        return out
    tiles = F.pad(flat, (0, nb * block - d)).reshape(m * nb, block)
    return quantize_kernel(tiles, u, bits)[0].reshape(m, nb * block)[:, :d]
