"""Which device activity is which work, by the name the profiler gives it.

* ``b1``: the block top-k kernel (``csrc/topk_compress.cu``);
* ``b4``: the stochastic quantizer (``csrc/quantize.cu``);
* ``gemm``: cuBLAS and CUTLASS matrix products (GEMM, GEMV, dot, their
  split-K reductions);
* ``elementwise``: elementwise, copy, fill, memcpy, memset and reduction
  kernels;
* ``other``: the rest (softmax, sort, embedding backward, ...).
"""

from __future__ import annotations

_OWN = (("topk_kernel", "b1"), ("quant_kernel", "b4"))
_GEMM = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitkreduce", "dot_kernel", "cublas")
_ELEMENTWISE = ("elementwise", "vectorized", "unrolled", "reduce_kernel", "memcpy", "memset", "copy",
                "fill", "catarraybatched")


def classify(name: str) -> str:
    low = name.lower()
    for key, cls in _OWN:
        if key in low:
            return cls
    if any(k in low for k in _GEMM):
        return "gemm"
    if any(k in low for k in _ELEMENTWISE):
        return "elementwise"
    return "other"
