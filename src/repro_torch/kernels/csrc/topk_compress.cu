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
// round, as the reference computes in bf16.  Built without fast math: no
// flush-to-zero, IEEE rounding on every add and multiply.
//
// NaN.  hi is the integer maximum of the magnitudes' bit patterns.  A NaN's
// magnitude bits lie above +inf's, so a row holding a NaN gets a NaN hi, as
// torch.amax and jnp.max give; every mid is then NaN, every count 0, lo
// stays 0, and the row comes back as x * [|x| >= 0]: every finite value
// (-0.0 included) unchanged and every NaN lane NaN.  fmaxf would drop the
// NaN and bisect on the largest other value instead.
//
// Bound on an H100 (3.35 TB/s): one read and one write of the tile.  At the
// main path's shape, (19,850, 1,024) f32, that is 162.6 MB, so >= 48.5 us
// (bf16: 24.3 us).  The arithmetic is 24 rounds of one compare and one add
// a value, about 1e9 operations, far below any peak rate; what competes
// with the bytes is instruction issue, about 0.92e12 warp instructions a
// second on the card's 528 schedulers, and the latency of dependent
// instructions, with few warps a scheduler to hide it.  So the count is
// written for few instructions in short chains: a value costs 2 a round in
// f32 (FSET, FADD into one of four sums) and 0.75 in bf16 (HSET2 compares
// two packed values).
//
// Design.  block <= 1,024: one warp per row, 8 rows per CTA of 256 threads.
// Each lane holds V = block / 32 values in registers (32 at block 1,024),
// loaded as V / 4 vectors of 4 consecutive elements (16 bytes in f32, 8 in
// bf16), neighbouring lanes on neighbouring vectors, so the row is read
// once, coalesced, and written once the same way.  A round counts the
// lane's own V values (no padding slots) and sums the warp with one
// __reduce_add_sync; every lane derives the same mid from the same warp
// total, so lo and hi stay uniform with no shared memory and no barrier.
// V is a template parameter, so the count is unrolled over exactly the real
// values.  block > 1,024 (up to 4,096): one CTA of block / 4 threads per
// row, 4 values a thread; a round's warp totals are summed through shared
// memory, double-buffered by round parity so one __syncthreads a round
// suffices.  Both read either (nb, block) tiles or a node-stacked flat leaf
// (m, d) in place (struct Rows): the wrapper then pads and slices nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRowsPerCta = 8;       // warp kernel: one row a warp
constexpr int kMaxWarpBlock = 1024;  // warp kernel: V = block / 32 <= 32
constexpr int kMaxBlock = 4096;      // CTA kernel: block / 4 threads <= 1,024
constexpr int kBisectIters = 24;     // repro/kernels/ref.py BISECT_ITERS
constexpr unsigned kAll = 0xffffffffu;

// How a dtype's values sit in registers and how they are counted.  Raw is
// the vector of 4 consecutive elements moved in one load or store; Reg the
// register that holds one f32 value, or two bf16 values side by side.
// count() is the number of a thread's values with |x| >= mid.
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  using Raw = float4;
  using Reg = float;
  using Mid = float;
  static constexpr int kValuesPerReg = 1;
  static __device__ __forceinline__ void unpack(Raw v, Reg* r) {
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  }
  static __device__ __forceinline__ Raw pack(const Reg* r) {
    return make_float4(r[0], r[1], r[2], r[3]);
  }
  // the magnitude's bit pattern (a NaN's lies above +inf's)
  static __device__ __forceinline__ unsigned max_bits(Reg r) {
    return __float_as_uint(r) & 0x7fffffffu;
  }
  // arithmetic in the input dtype: f32 needs no extra rounding
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ Mid splat(float v) { return v; }
  // A compare that writes 1.0 or 0.0 (FSET, false for a NaN on either side)
  // and an FADD, a value; four independent sums (exact: at most 32 ones
  // each), so no long chain of dependent adds.  A compare and select into
  // one integer sum ran slower on the card, fewer instructions or not.
  template <int N>
  static __device__ __forceinline__ unsigned count(const Reg (&r)[N], Mid mid) {
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < N; ++i) c[i % 4] += fabsf(r[i]) >= mid ? 1.0f : 0.0f;
    return static_cast<unsigned>((c[0] + c[1]) + (c[2] + c[3]));
  }
  static __device__ __forceinline__ Reg keep(Reg r, Mid lo) {
    return r * (fabsf(r) >= lo ? 1.0f : 0.0f);
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  using Raw = uint2;  // 4 bf16, 8 bytes
  using Reg = unsigned;  // a bf16x2: element 2i in the low half, 2i + 1 in the high
  using Mid = unsigned;
  static constexpr int kValuesPerReg = 2;
  static __device__ __forceinline__ __nv_bfloat162 h2(unsigned u) {
    return *reinterpret_cast<const __nv_bfloat162*>(&u);
  }
  static __device__ __forceinline__ unsigned u32(__nv_bfloat162 h) {
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ __forceinline__ void unpack(Raw v, Reg* r) {
    r[0] = v.x;
    r[1] = v.y;
  }
  static __device__ __forceinline__ Raw pack(const Reg* r) { return make_uint2(r[0], r[1]); }
  // the larger magnitude of the two, as the bit pattern of the f32 of the
  // same value (a bf16 is the top half of that f32)
  static __device__ __forceinline__ unsigned max_bits(Reg r) {
    return max((r << 16) & 0x7fff0000u, r & 0x7fff0000u);
  }
  // an f32 sum of two bf16 values rounded once to bf16 equals the bf16 sum
  // (24 >= 2 * 8 + 2 bits, so the double rounding is innocuous)
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // mid is a bf16 value, so its f32 bits' top half is its bf16
  static __device__ __forceinline__ Mid splat(float v) { return (__float_as_uint(v) >> 16) * 0x10001u; }
  // HSET2 compares two values at once, writing 0xffff in each half where
  // |x| >= mid, and an IADD3 adds two such masks: 0.75 instructions a value.
  // With lo and hi the thread's counts of low and high halves, the sum is
  // lo * 0xffff + hi * 0xffff0000 = (lo - hi) * 2^16 - lo (mod 2^32), and
  // lo, hi <= 16: the low half of the sum gives lo, the high half then
  // lo - hi.
  template <int N>
  static __device__ __forceinline__ unsigned count(const Reg (&r)[N], Mid mid) {
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < N; i += 2)
      s += __hge2_mask(__habs2(h2(r[i])), h2(mid)) + __hge2_mask(__habs2(h2(r[i + 1])), h2(mid));
    const unsigned lo = (0u - s) & 0xffffu;
    const int diff = static_cast<short>((s + lo) >> 16);
    return 2 * lo - diff;
  }
  // x * [|x| >= lo] in bf16: the compare gives 1.0 or 0.0 in each half
  static __device__ __forceinline__ Reg keep(Reg r, Mid lo) {
    return u32(__hmul2(h2(r), __hge2(__habs2(h2(r)), h2(lo))));
  }
};

template <typename T>
__device__ __forceinline__ float midpoint(float lo, float hi) {
  return Lanes<T>::round(0.5f * Lanes<T>::round(lo + hi));
}

// Where the rows lie.  Row r is block b = r % nbn of node r / nbn, whose
// d elements start at node * d: the elements [b * block, b * block + block)
// of that node.  A tile is the case d = block, one row a node.  In a node's
// last row, the elements past d count as 0.0 (the zero padding the
// reference cuts blocks with) and are never written.  Offsets and sizes are
// in vectors of 4 elements (d % 4 == 0).
struct Rows {
  int nbn;   // rows a node, ceil(d / block)
  int d4;    // a node's elements
  int row4;  // a row's elements (block)
  __device__ __forceinline__ size_t base(size_t r) const {
    const size_t node = r / nbn;
    return node * d4 + (r - node * nbn) * row4;
  }
  __device__ __forceinline__ int valid(size_t r) const {
    return min(row4, d4 - static_cast<int>(r % nbn) * row4);
  }
};

// A thread's N registers: vector g of the thread is vector g * stride + t
// of the row, stride being the threads a row; vectors at or past `valid`
// read as zeros.
template <typename T, int N>
__device__ __forceinline__ void load(const typename Lanes<T>::Raw* xr, int stride, int t, int valid,
                                     typename Lanes<T>::Reg (&r)[N]) {
  constexpr int per = 4 / Lanes<T>::kValuesPerReg;  // registers a vector
#pragma unroll
  for (int g = 0; g < N / per; ++g) {
    const int i = g * stride + t;
    if (i < valid) {
      Lanes<T>::unpack(xr[i], r + per * g);
    } else {
#pragma unroll
      for (int j = 0; j < per; ++j) r[per * g + j] = typename Lanes<T>::Reg{};
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(typename Lanes<T>::Raw* orow, int stride, int t, int valid,
                                      typename Lanes<T>::Reg (&r)[N], float lo) {
  constexpr int per = 4 / Lanes<T>::kValuesPerReg;
  const typename Lanes<T>::Mid lo2 = Lanes<T>::splat(lo);
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = Lanes<T>::keep(r[i], lo2);
#pragma unroll
  for (int g = 0; g < N / per; ++g)
    if (g * stride + t < valid) orow[g * stride + t] = Lanes<T>::pack(r + per * g);
}

template <typename T, int N>
__device__ __forceinline__ unsigned max_bits(const typename Lanes<T>::Reg (&r)[N]) {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) m = max(m, Lanes<T>::max_bits(r[i]));
  return m;
}

// the warp's count of values with |x| >= mid
template <typename T, int N>
__device__ __forceinline__ unsigned warp_count(const typename Lanes<T>::Reg (&r)[N], float mid) {
  return __reduce_add_sync(kAll, Lanes<T>::count(r, Lanes<T>::splat(mid)));
}

// V values a lane, in N registers
template <typename T, int V, int N = V / Lanes<T>::kValuesPerReg>
__global__ void __launch_bounds__(kRowsPerCta * 32)
    warp_topk_kernel(const typename Lanes<T>::Raw* __restrict__ x,
                     typename Lanes<T>::Raw* __restrict__ out, int nb, Rows rows, int k) {
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(nb)) return;
  const size_t base = rows.base(row);
  const int valid = rows.valid(row);

  typename Lanes<T>::Reg r[N];
  load<T>(x + base, 32, lane, valid, r);
  float hi = __uint_as_float(__reduce_max_sync(kAll, max_bits<T>(r)));
  float lo = 0.0f;
#pragma unroll 1
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = midpoint<T>(lo, hi);
    if (warp_count<T>(r, mid) >= static_cast<unsigned>(k)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  store<T>(out + base, 32, lane, valid, r, lo);
}

template <typename T, int N = 4 / Lanes<T>::kValuesPerReg>
__global__ void __launch_bounds__(kMaxBlock / 4)
    cta_topk_kernel(const typename Lanes<T>::Raw* __restrict__ x,
                    typename Lanes<T>::Raw* __restrict__ out, Rows rows, int k) {
  __shared__ unsigned s_max[32];
  __shared__ unsigned s_cnt[2][32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = blockDim.x >> 5;
  const size_t base = rows.base(blockIdx.x);
  const int valid = rows.valid(blockIdx.x);

  typename Lanes<T>::Reg r[N];
  load<T>(x + base, blockDim.x, t, valid, r);
  const unsigned m = __reduce_max_sync(kAll, max_bits<T>(r));
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  unsigned hbits = 0;
  for (int w = 0; w < warps; ++w) hbits = max(hbits, s_max[w]);
  float hi = __uint_as_float(hbits);
  float lo = 0.0f;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = midpoint<T>(lo, hi);
    const unsigned c = warp_count<T>(r, mid);
    if (lane == 0) s_cnt[it & 1][warp] = c;
    __syncthreads();
    unsigned total = 0;
    for (int w = 0; w < warps; ++w) total += s_cnt[it & 1][w];
    if (total >= static_cast<unsigned>(k)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  store<T>(out + base, blockDim.x, t, valid, r, lo);
}

template <typename T, int V>
void launch_warp(const void* x, void* out, int nb, Rows rows, int k, cudaStream_t stream) {
  using Raw = typename Lanes<T>::Raw;
  const int grid = (nb + kRowsPerCta - 1) / kRowsPerCta;
  warp_topk_kernel<T, V><<<grid, kRowsPerCta * 32, 0, stream>>>(
      static_cast<const Raw*>(x), static_cast<Raw*>(out), nb, rows, k);
}

// nb rows of `block` over nodes of d elements each (a tile: d = block)
template <typename T>
int launch(const void* x, void* out, int nb, int block, int d, int k, void* stream_) {
  using Raw = typename Lanes<T>::Raw;
  if (nb < 0 || block <= 0 || block % 128 != 0 || block > kMaxBlock || k < 1 || k > block ||
      d <= 0 || d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{(d + block - 1) / block, d / 4, block / 4};
  if (nb % rows.nbn != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (block > kMaxWarpBlock) {
    cta_topk_kernel<T><<<nb, block / 4, 0, stream>>>(static_cast<const Raw*>(x),
                                                     static_cast<Raw*>(out), rows, k);
    return static_cast<int>(cudaGetLastError());
  }
  switch (block / 128) {  // V = block / 32 values a lane
    case 1: launch_warp<T, 4>(x, out, nb, rows, k, stream); break;
    case 2: launch_warp<T, 8>(x, out, nb, rows, k, stream); break;
    case 3: launch_warp<T, 12>(x, out, nb, rows, k, stream); break;
    case 4: launch_warp<T, 16>(x, out, nb, rows, k, stream); break;
    case 5: launch_warp<T, 20>(x, out, nb, rows, k, stream); break;
    case 6: launch_warp<T, 24>(x, out, nb, rows, k, stream); break;
    case 7: launch_warp<T, 28>(x, out, nb, rows, k, stream); break;
    default: launch_warp<T, 32>(x, out, nb, rows, k, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (nb, block) tiles
extern "C" int block_topk_f32(const void* x, void* out, int nb, int block, int k,
                              void* stream) {
  return launch<float>(x, out, nb, block, block, k, stream);
}

extern "C" int block_topk_bf16(const void* x, void* out, int nb, int block, int k,
                               void* stream) {
  return launch<__nv_bfloat16>(x, out, nb, block, block, k, stream);
}

// a node-stacked flat leaf (m, d), read and written in place: nb = m * ceil(d / block)
extern "C" int block_topk_leaf_f32(const void* x, void* out, int nb, int block, int d, int k,
                                   void* stream) {
  return launch<float>(x, out, nb, block, d, k, stream);
}

extern "C" int block_topk_leaf_bf16(const void* x, void* out, int nb, int block, int d, int k,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, out, nb, block, d, k, stream);
}
