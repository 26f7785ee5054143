// Per-row-scaled stochastic uniform quantization, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantize.py, quantize_pallas (kernel body
// _quant_kernel).  Plain version: repro_torch/kernels/ref.py, quantize_ref.
//
// (nb, block) x and U[0,1) samples u of one dtype (f32 or bf16) -> (nb,
// block) dequantized out and (nb,) scales, both in that dtype.  Per row:
//   scale = max(max|x|, 1e-12)             (NaN if the row holds a NaN)
//   steps = (x / scale + 1) * 0.5 * levels, levels = 2^bits - 1
//   lo    = floor(steps)
//   q     = lo + (u < steps - lo)
//   out   = ((q / levels) * 2 - 1) * scale
// Every op rounds once to the dtype, as PyTorch's op-by-op kernels and the
// reference's jnp oracle do: the chain is written with __fdiv_rn /
// __fadd_rn / __fmul_rn / __fsub_rn, so nvcc cannot contract a multiply
// and an add into an FMA, and division is IEEE.  For bf16 each op is
// computed in f32 from bf16 operands and rounded to bf16 once
// (__float2bfloat16_rn): for +, -, x and / of two bf16 values that equals
// the bf16 op, since f32's 24 bits are at least 2 * 8 + 2.  1e-12 is the
// bf16 constant the reference's jnp.maximum sees.  fmaxf drops NaN, so the
// row's NaN is carried beside the maximum and forces a NaN scale.
//
// Bound on an H100 (3.35 TB/s), at the main path's shape (19,850, 1,024):
// f32 reads x and u (81.3 MB each) and writes out (81.3 MB) and the scales
// (79 KB): 244.0 MB, >= 72.8 us; bf16 moves half: 122.0 MB, >= 36.4 us.
// About 12 flops a value, far below the f32 rate: the kernel is bound by
// bytes.
//
// Design.  One warp per row, 8 rows per CTA of 256 threads: the row's
// maximum is a warp-shuffle reduction, with no CTA-wide barrier.  Lanes read
// the row four values at a time (a float4, or a uint2 of four bf16;
// block % 128 == 0, so every lane takes the same number of loads,
// neighbouring lanes on neighbouring addresses).  Pass 1 reads x for the
// maximum; pass 2 reads x again (from L1/L2: the row is 4 KB at block 1,024
// in f32) with u and writes out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kThreads = kWarpsPerCta * 32;

// Four values of one dtype as a vector load, widened to f32, and back.
template <typename T>
struct Io;

template <>
struct Io<float> {
  using Vec = float4;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void load(const Vec& v, float (&f)[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ Vec pack(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ float floor_const() { return 1e-12f; }
};

template <>
struct Io<__nv_bfloat16> {
  using Vec = uint2;  // four bf16
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void load(const Vec& v, float (&f)[4]) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    f[0] = __low2float(a); f[1] = __high2float(a);
    f[2] = __low2float(b); f[3] = __high2float(b);
  }
  // every value is already a bf16 value, so these conversions are exact
  static __device__ __forceinline__ Vec pack(const float (&f)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    Vec v;
    v.x = *reinterpret_cast<const unsigned int*>(&a);
    v.y = *reinterpret_cast<const unsigned int*>(&b);
    return v;
  }
  static __device__ __forceinline__ float floor_const() { return round(1e-12f); }
};

template <typename T>
__device__ __forceinline__ float quant(float x, float u, float scale, float levels) {
  using R = Io<T>;
  const float y = R::round(__fdiv_rn(x, scale));
  const float half = R::round(__fmul_rn(R::round(__fadd_rn(y, 1.0f)), 0.5f));
  const float steps = R::round(__fmul_rn(half, levels));
  const float lo = floorf(steps);
  const float frac = R::round(__fsub_rn(steps, lo));
  const float q = R::round(__fadd_rn(lo, u < frac ? 1.0f : 0.0f));
  const float twice = R::round(__fmul_rn(R::round(__fdiv_rn(q, levels)), 2.0f));
  const float deq = R::round(__fsub_rn(twice, 1.0f));
  return R::round(__fmul_rn(deq, scale));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const typename Io<T>::Vec* __restrict__ x,
                    const typename Io<T>::Vec* __restrict__ u,
                    typename Io<T>::Vec* __restrict__ out, T* __restrict__ scales,
                    int nb, int block, float levels) {
  using R = Io<T>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kWarpsPerCta + warp;
  if (row >= static_cast<size_t>(nb)) return;
  const int n4 = block >> 2;
  const typename R::Vec* xr = x + row * n4;
  const typename R::Vec* ur = u + row * n4;
  typename R::Vec* orow = out + row * n4;

  float amax = 0.0f;
  bool nan = false;
  for (int j = lane; j < n4; j += 32) {
    float v[4];
    R::load(xr[j], v);
    amax = fmaxf(fmaxf(amax, fabsf(v[0])), fabsf(v[1]));
    amax = fmaxf(fmaxf(amax, fabsf(v[2])), fabsf(v[3]));
    nan |= isnan(v[0]) | isnan(v[1]) | isnan(v[2]) | isnan(v[3]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  nan = __any_sync(0xffffffffu, nan);
  // amax is one of the row's values, so it is exact in T
  const float scale = nan ? __int_as_float(0x7fc00000) : fmaxf(amax, R::floor_const());
  if (lane == 0) scales[row] = static_cast<T>(scale);

  for (int j = lane; j < n4; j += 32) {
    float v[4], r[4], o[4];
    R::load(xr[j], v);
    R::load(ur[j], r);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = quant<T>(v[e], r[e], scale, levels);
    orow[j] = R::pack(o);
  }
}

template <typename T>
int launch(const void* x, const void* u, void* out, void* scales, int nb, int block,
           int bits, void* stream) {
  using Vec = typename Io<T>::Vec;
  if (nb < 0 || block <= 0 || block % 128 != 0 || bits < 1 || bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  const int grid = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  quantize_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Vec*>(x), static_cast<const Vec*>(u), static_cast<Vec*>(out),
      static_cast<T*>(scales), nb, block, static_cast<float>((1 << bits) - 1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quantize_f32(const void* x, const void* u, void* out, void* scales,
                            int nb, int block, int bits, void* stream) {
  return launch<float>(x, u, out, scales, nb, block, bits, stream);
}

extern "C" int quantize_bf16(const void* x, const void* u, void* out, void* scales,
                             int nb, int block, int bits, void* stream) {
  return launch<__nv_bfloat16>(x, u, out, scales, nb, block, bits, stream);
}
