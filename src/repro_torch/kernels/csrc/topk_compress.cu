// Block top-k by threshold bisection, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/topk_compress.py, block_topk_pallas (kernel
// body _topk_kernel).  Plain version: repro_torch/kernels/ref.py,
// block_topk_ref.  The two agree bit for bit.
//
// What it computes, per (block,)-row of an (nb, block) array:
//   hi = max|x|, lo = 0;
//   24 times: mid = 0.5 * (lo + hi);  lo = mid if count(|x| >= mid) >= k,
//             else hi = mid;
//   out = x * [|x| >= lo]            (so a dropped negative is -0.0)
// in the input dtype: for bf16, lo + hi and mid are rounded to bf16 every
// round, as the reference computes in bf16.
//
// Bound on an H100 (3.35 TB/s): one read and one write of the tile.  At the
// main path's shape, (19,850, 1,024) f32, that is 162.6 MB, so >= 48.5 us.
// The 24 rounds are ~26 operations a value, ~8 us at 67 TFLOP/s f32, well
// under the memory time.
//
// Design: one CTA of 256 threads per row.  The row is read from device
// memory ONCE, into registers (block / 256 <= 16 values a thread, lanes
// strided by 256 so every load is coalesced); all 24 counts run on the
// registers.  A round's count is a per-thread count, a warp reduction
// (redux.sync) and a sum of the 8 warp totals in shared memory; the shared
// slots are double-buffered by round parity, so one __syncthreads a round
// suffices.  Every thread derives the same mid from the same totals, so lo
// and hi stay uniform without broadcasting them.  The max is a warp-shuffle
// reduction plus one pass over the warp maxima.  Built without fast math:
// no flush-to-zero, IEEE rounding on every add and multiply.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;  // block <= 4096
constexpr int kBisectIters = 24;   // repro/kernels/ref.py BISECT_ITERS

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  // arithmetic in the input dtype: f32 needs no extra rounding
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);  // exact: v is a bf16 value times 0 or 1
  }
  // an f32 sum of two bf16 values rounded once to bf16 equals the bf16 sum
  // (24 >= 2 * 8 + 2 bits, so the double rounding is innocuous)
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_topk_kernel(const T* __restrict__ x, T* __restrict__ out, int block, int k) {
  __shared__ float s_max[kWarps];
  __shared__ unsigned s_cnt[2][kWarps];

  const size_t base = static_cast<size_t>(blockIdx.x) * block;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float xv[kMaxPerThread];
  float av[kMaxPerThread];  // |x|; -1 marks a lane past the row
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int l = j * kThreads + tid;
    if (l < block) {
      xv[j] = Num<T>::load(x + base + l);
      av[j] = fabsf(xv[j]);
    } else {
      xv[j] = 0.0f;
      av[j] = -1.0f;
    }
    amax = fmaxf(amax, av[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) s_max[warp] = amax;
  __syncthreads();
  float hi = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) hi = fmaxf(hi, s_max[w]);
  float lo = 0.0f;

  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = Num<T>::round(0.5f * Num<T>::round(lo + hi));
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) c += av[j] >= mid ? 1u : 0u;
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) s_cnt[it & 1][warp] = c;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_cnt[it & 1][w];
    if (total >= static_cast<unsigned>(k)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int l = j * kThreads + tid;
    if (l < block) Num<T>::store(out + base + l, xv[j] * (av[j] >= lo ? 1.0f : 0.0f));
  }
}

template <typename T>
int launch(const void* x, void* out, int nb, int block, int k, void* stream) {
  if (nb < 0 || block <= 0 || block > kThreads * kMaxPerThread || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  block_topk_kernel<T><<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), block, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int block_topk_f32(const void* x, void* out, int nb, int block, int k,
                              void* stream) {
  return launch<float>(x, out, nb, block, k, stream);
}

extern "C" int block_topk_bf16(const void* x, void* out, int nb, int block, int k,
                               void* stream) {
  return launch<__nv_bfloat16>(x, out, nb, block, k, stream);
}
