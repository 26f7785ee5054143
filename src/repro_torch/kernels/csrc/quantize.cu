// Per-row-scaled stochastic uniform quantization, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantize.py, quantize_pallas (kernel body
// _quant_kernel).  Plain version: repro_torch/kernels/ref.py, quantize_ref.
//
// (nb, block) f32 x and U[0,1) samples u -> (nb, block) f32 dequantized out
// and (nb,) f32 scales.  Per row:
//   scale = max(max|x|, 1e-12)             (NaN if the row holds a NaN)
//   steps = (x / scale + 1) * 0.5 * levels, levels = 2^bits - 1
//   lo    = floor(steps)
//   q     = lo + (u < steps - lo)
//   out   = ((q / levels) * 2 - 1) * scale
// Every op rounds once, as PyTorch's op-by-op kernels and the reference's
// jnp oracle do: the chain is written with __fdiv_rn / __fadd_rn /
// __fmul_rn / __fsub_rn, so nvcc cannot contract a multiply and an add into
// an FMA, and division is IEEE.  fmaxf drops NaN, so the row's NaN is
// carried beside the maximum and forces a NaN scale.
//
// Bound on an H100 (3.35 TB/s), at the main path's shape (19,850, 1,024):
// read x and u (81.3 MB each), write out (81.3 MB) and the scales (79 KB):
// 244.0 MB, >= 72.8 us.  About 12 flops a value, far below the f32 rate:
// the kernel is bound by bytes.
//
// Design.  One warp per row, 8 rows per CTA of 256 threads: the row's
// maximum is a warp-shuffle reduction, with no CTA-wide barrier.  Lanes read
// the row as float4 (block % 128 == 0, so every lane takes the same number
// of 16-byte loads, neighbouring lanes on neighbouring addresses).  Pass 1
// reads x for the maximum; pass 2 reads x again (from L1/L2: the row is
// 4 KB at block 1,024) with u and writes out.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kThreads = kWarpsPerCta * 32;

__device__ __forceinline__ float quant(float x, float u, float scale, float levels) {
  const float y = __fdiv_rn(x, scale);
  const float steps = __fmul_rn(__fmul_rn(__fadd_rn(y, 1.0f), 0.5f), levels);
  const float lo = floorf(steps);
  const float q = __fadd_rn(lo, u < __fsub_rn(steps, lo) ? 1.0f : 0.0f);
  const float deq = __fsub_rn(__fmul_rn(__fdiv_rn(q, levels), 2.0f), 1.0f);
  return __fmul_rn(deq, scale);
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float4* __restrict__ x, const float4* __restrict__ u,
                    float4* __restrict__ out, float* __restrict__ scales, int nb,
                    int block, float levels) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kWarpsPerCta + warp;
  if (row >= static_cast<size_t>(nb)) return;
  const int n4 = block >> 2;
  const float4* xr = x + row * n4;
  const float4* ur = u + row * n4;
  float4* orow = out + row * n4;

  float amax = 0.0f;
  bool nan = false;
  for (int j = lane; j < n4; j += 32) {
    const float4 v = xr[j];
    amax = fmaxf(fmaxf(amax, fabsf(v.x)), fabsf(v.y));
    amax = fmaxf(fmaxf(amax, fabsf(v.z)), fabsf(v.w));
    nan |= isnan(v.x) | isnan(v.y) | isnan(v.z) | isnan(v.w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  nan = __any_sync(0xffffffffu, nan);
  const float scale = nan ? __int_as_float(0x7fc00000) : fmaxf(amax, 1e-12f);
  if (lane == 0) scales[row] = scale;

  for (int j = lane; j < n4; j += 32) {
    const float4 v = xr[j];
    const float4 r = ur[j];
    float4 o;
    o.x = quant(v.x, r.x, scale, levels);
    o.y = quant(v.y, r.y, scale, levels);
    o.z = quant(v.z, r.z, scale, levels);
    o.w = quant(v.w, r.w, scale, levels);
    orow[j] = o;
  }
}

}  // namespace

extern "C" int quantize_f32(const void* x, const void* u, void* out, void* scales,
                            int nb, int block, int bits, void* stream) {
  if (nb < 0 || block <= 0 || block % 128 != 0 || bits < 1 || bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  const int grid = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  quantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(u),
      static_cast<float4*>(out), static_cast<float*>(scales), nb, block,
      static_cast<float>((1 << bits) - 1));
  return static_cast<int>(cudaGetLastError());
}
