// Per-row-scaled stochastic uniform quantization, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantize.py, quantize_pallas (kernel body
// _quant_kernel).  Plain version: repro_torch/kernels/ref.py, quantize_ref.
// The two agree bit for bit.
//
// What it computes, per (block,)-row, in one dtype T (f32 or bf16), every
// op rounding once to T as PyTorch's op-by-op kernels and the reference's
// jnp oracle do:
//   scale = max(max|x|, 1e-12)             (NaN if the row holds a NaN)
//   y     = x / scale
//   steps = ((y + 1) * 0.5) * levels,      levels = 2^bits - 1
//   lo    = floor(steps)
//   q     = lo + (u < steps - lo)
//   out   = (((q / levels) * 2) - 1) * scale
// with U[0,1) samples u passed in.  Where the kernel computes this another
// way, it is the same value bit for bit:
// - steps = (y + 1) * (levels / 2): y + 1 lies in {0} or [2^-24, 2], so
//   halving it is exact, and levels / 2 is exact in T.
// - lo, steps - lo and q are exact in T (steps - lo keeps a subset of
//   steps's bits, and q is an integer <= levels <= 255), so none needs
//   rounding.
// - (((q / levels) * 2) - 1) depends on q alone: a table of levels + 1 <=
//   256 entries in shared memory, built per CTA with the same rounded op
//   chain, replaces one division and three roundings a value.
// - bf16 x / scale is bf16(x * rn32(1 / scale)): a quotient of two 8-bit
//   significands lies far (about 2^-18 relative) from a bf16 rounding
//   midpoint, and the f32 product errs by less than 2^-22, so both round to
//   the same bf16 (the CPU tests check every finite bf16 |x| <= scale on a
//   sample of scales and the extremes).  f32 keeps the IEEE division
//   (__fdiv_rn): 24-bit significands leave no such margin.
// - bf16 y + 1 and * (levels / 2) are packed bf16x2 ops that round once
//   (__hadd2_rn, __hmul2_rn: never contracted into an FMA); table[q] *
//   scale is exact in f32 (8 x 8 bits), so one rounding to bf16 follows.
// Every other op is written with __fdiv_rn / __fadd_rn / __fmul_rn /
// __fsub_rn, so nvcc contracts nothing into an FMA.  1e-12 is the bf16
// constant the reference's jnp.maximum sees.  The row maximum is the
// integer maximum of the magnitudes' bit patterns, where a NaN lies above
// +inf, so a NaN row gets a NaN scale (fmaxf would drop the NaN).  A row
// whose scale is NaN or inf can give NaN steps, which index no table
// entry: such rows (a warp-uniform branch) take a path that returns NaN
// for them.
//
// Bound on an H100 (3.35 TB/s), at the main path's shape (19,850, 1,024):
// f32 reads x and u (81.3 MB each) and writes out (81.3 MB): 244.0 MB,
// >= 72.8 us; bf16 moves half: 122.0 MB, >= 36.4 us.  About ten
// operations a value, far below any peak rate, but instruction issue
// competes with the bytes (about 0.92e12 warp instructions a second on the
// card's 528 schedulers), so the chain is written for few instructions.
//
// Design.  block <= 1,024: one warp per row, 8 rows per CTA of 256
// threads; each lane holds V = block / 32 values of x in registers (32 at
// block 1,024), loaded as vectors of 4 (a float4, or a uint2 of four
// bf16), neighbouring lanes on neighbouring vectors.  x is read once: the
// row maximum (one __reduce_max_sync) and the quantization both come from
// the registers; u is read once beside the store.  block > 1,024 (up to
// 4,096): one CTA of block / 4 threads a row, 4 values a thread, the
// maximum across warps through shared memory.  x and out are either (nb,
// block) tiles or a node-stacked flat leaf (m, d) read and written in
// place (struct Rows: the tail of a node's last block reads as 0.0 and is
// never written); u always lies in the (m * nb, block) tile layout its
// draw has.  The per-row scales are written only where asked for (the
// tile entry points).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRowsPerCta = 8;       // warp kernel: one row a warp
constexpr int kMaxWarpBlock = 1024;  // warp kernel: V = block / 32 <= 32
constexpr int kMaxBlock = 4096;      // CTA kernel: block / 4 threads <= 1,024
constexpr int kMaxLevels = 255;      // bits <= 8
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;

// A row's constants: its scale (a value of T), bf16's f32 reciprocal of
// it, levels / 2, and the dequantization table in shared memory.
struct RowQ {
  float scale;
  float inv;
  float half_levels;
  unsigned half_levels2;  // bf16x2 of half_levels (bf16 only)
  const float* table;
};

// q < steps - lo: q's code, exact in T; the table's entry times the scale.
// kFinite: the row's scale is finite, so steps is never NaN.
template <bool kFinite>
__device__ __forceinline__ float dequant(float steps, float u, const RowQ& q) {
  if (!kFinite && isnan(steps)) return __int_as_float(0x7fc00000);
  const float lo = floorf(steps);
  const int code = static_cast<int>(lo) + (u < __fsub_rn(steps, lo) ? 1 : 0);
  return __fmul_rn(q.table[code], q.scale);
}

// How a dtype's values sit in registers.  Raw is the vector of 4
// consecutive elements moved in one load or store; Reg the register that
// holds one f32 value, or two bf16 values side by side.
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  using Raw = float4;
  using Reg = float;
  static constexpr int kValuesPerReg = 1;
  static __device__ __forceinline__ void unpack(Raw v, Reg* r) {
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float floor_const() { return 1e-12f; }
  static __device__ __forceinline__ void store_scale(float* s, float v) { *s = v; }
  // the magnitude's bit pattern (a NaN's lies above +inf's)
  static __device__ __forceinline__ unsigned max_bits(Reg r) { return __float_as_uint(r) & 0x7fffffffu; }
  template <bool kFinite>
  static __device__ __forceinline__ float one(float x, float u, const RowQ& q) {
    const float steps = __fmul_rn(__fadd_rn(__fdiv_rn(x, q.scale), 1.0f), q.half_levels);
    return dequant<kFinite>(steps, u, q);
  }
  // the 4 values of one vector, with their samples
  template <bool kFinite>
  static __device__ __forceinline__ Raw quant(const Reg* r, Raw u, const RowQ& q) {
    return make_float4(one<kFinite>(r[0], u.x, q), one<kFinite>(r[1], u.y, q),
                       one<kFinite>(r[2], u.z, q), one<kFinite>(r[3], u.w, q));
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  using Raw = uint2;     // 4 bf16, 8 bytes
  using Reg = unsigned;  // a bf16x2: element 2i in the low half, 2i + 1 in the high
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
  // an f32 op of bf16 operands rounded once to bf16 equals the bf16 op
  // (24 >= 2 * 8 + 2 bits, so the double rounding is innocuous)
  static __device__ __forceinline__ float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  static __device__ __forceinline__ float floor_const() { return round(1e-12f); }
  static __device__ __forceinline__ void store_scale(__nv_bfloat16* s, float v) { *s = __float2bfloat16_rn(v); }
  // the larger magnitude of the two, as the bit pattern of the f32 of the
  // same value (a bf16 is the top half of that f32)
  static __device__ __forceinline__ unsigned max_bits(Reg r) {
    return max((r << 16) & 0x7fff0000u, r & 0x7fff0000u);
  }
  // two values: y = bf16(x * rn32(1 / scale)), steps = (y + 1) * (levels / 2)
  // in packed bf16, then the code and the table entry in f32
  template <bool kFinite>
  static __device__ __forceinline__ unsigned pair(Reg r, unsigned u, const RowQ& q) {
    const float2 x = __bfloat1622float2(h2(r));
    const __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(x.x, q.inv), __fmul_rn(x.y, q.inv));
    const float2 steps = __bfloat1622float2(
        __hmul2_rn(__hadd2_rn(y, __float2bfloat162_rn(1.0f)), h2(q.half_levels2)));
    const float2 uf = __bfloat1622float2(h2(u));
    return u32(__floats2bfloat162_rn(dequant<kFinite>(steps.x, uf.x, q), dequant<kFinite>(steps.y, uf.y, q)));
  }
  template <bool kFinite>
  static __device__ __forceinline__ Raw quant(const Reg* r, Raw u, const RowQ& q) {
    return make_uint2(pair<kFinite>(r[0], u.x, q), pair<kFinite>(r[1], u.y, q));
  }
};

// (((c / levels) * 2) - 1) for every code c in [0, levels], rounded to T
// after each op, by the CTA's threads
template <typename T>
__device__ __forceinline__ void fill_table(float* table, int levels, int t, int threads) {
  using L = Lanes<T>;
  const float lv = static_cast<float>(levels);
  for (int c = t; c <= levels; c += threads) {
    const float frac = L::round(__fdiv_rn(static_cast<float>(c), lv));
    table[c] = L::round(__fsub_rn(L::round(__fmul_rn(frac, 2.0f)), 1.0f));
  }
}

// The row's constants from the bit pattern of its largest magnitude.
template <typename T>
__device__ __forceinline__ RowQ row_constants(unsigned max_bits, int levels, const float* table) {
  RowQ q;
  // max_bits is one of the row's values, so the scale is exact in T
  q.scale = max_bits > kInfBits ? __int_as_float(0x7fc00000)
                                : fmaxf(__uint_as_float(max_bits), Lanes<T>::floor_const());
  q.inv = __frcp_rn(q.scale);
  q.half_levels = 0.5f * static_cast<float>(levels);  // exact in T: at most 8 bits
  q.half_levels2 = __float_as_uint(q.half_levels) >> 16;
  q.half_levels2 |= q.half_levels2 << 16;
  q.table = table;
  return q;
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
__device__ __forceinline__ unsigned max_bits(const typename Lanes<T>::Reg (&r)[N]) {
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) m = max(m, Lanes<T>::max_bits(r[i]));
  return m;
}

// Quantize the thread's registers with the samples of the same positions
// in the row's u and store the valid vectors.
template <typename T, bool kFinite, int N>
__device__ __forceinline__ void quant_store(const typename Lanes<T>::Raw* ur, typename Lanes<T>::Raw* orow,
                                            int stride, int t, int valid, const typename Lanes<T>::Reg (&r)[N],
                                            const RowQ& q) {
  constexpr int per = 4 / Lanes<T>::kValuesPerReg;
#pragma unroll
  for (int g = 0; g < N / per; ++g) {
    const int i = g * stride + t;
    if (i < valid) orow[i] = Lanes<T>::template quant<kFinite>(r + per * g, ur[i], q);
  }
}

template <typename T, int N>
__device__ __forceinline__ void finish_row(const typename Lanes<T>::Raw* ur, typename Lanes<T>::Raw* orow,
                                           int stride, int t, int valid, const typename Lanes<T>::Reg (&r)[N],
                                           const RowQ& q) {
  if (isfinite(q.scale)) {  // uniform across the row's threads
    quant_store<T, true>(ur, orow, stride, t, valid, r, q);
  } else {
    quant_store<T, false>(ur, orow, stride, t, valid, r, q);
  }
}

// V values a lane, in N registers
template <typename T, int V, int N = V / Lanes<T>::kValuesPerReg>
__global__ void __launch_bounds__(kRowsPerCta * 32)
    warp_quant_kernel(const typename Lanes<T>::Raw* __restrict__ x, const typename Lanes<T>::Raw* __restrict__ u,
                      typename Lanes<T>::Raw* __restrict__ out, T* __restrict__ scales, int nb, Rows rows,
                      int levels) {
  __shared__ float table[kMaxLevels + 1];
  fill_table<T>(table, levels, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(nb)) return;
  const size_t base = rows.base(row);
  const int valid = rows.valid(row);

  typename Lanes<T>::Reg r[N];
  load<T>(x + base, 32, lane, valid, r);
  const RowQ q = row_constants<T>(__reduce_max_sync(kAll, max_bits<T>(r)), levels, table);
  if (scales != nullptr && lane == 0) Lanes<T>::store_scale(scales + row, q.scale);
  finish_row<T>(u + row * rows.row4, out + base, 32, lane, valid, r, q);
}

template <typename T, int N = 4 / Lanes<T>::kValuesPerReg>
__global__ void __launch_bounds__(kMaxBlock / 4)
    cta_quant_kernel(const typename Lanes<T>::Raw* __restrict__ x, const typename Lanes<T>::Raw* __restrict__ u,
                     typename Lanes<T>::Raw* __restrict__ out, T* __restrict__ scales, Rows rows, int levels) {
  __shared__ float table[kMaxLevels + 1];
  __shared__ unsigned s_max[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warps = blockDim.x >> 5;
  const size_t row = blockIdx.x;
  const size_t base = rows.base(row);
  const int valid = rows.valid(row);
  fill_table<T>(table, levels, t, blockDim.x);

  typename Lanes<T>::Reg r[N];
  load<T>(x + base, blockDim.x, t, valid, r);
  const unsigned m = __reduce_max_sync(kAll, max_bits<T>(r));
  if (lane == 0) s_max[t >> 5] = m;
  __syncthreads();  // the table and every warp's maximum
  unsigned mb = 0;
  for (int w = 0; w < warps; ++w) mb = max(mb, s_max[w]);
  const RowQ q = row_constants<T>(mb, levels, table);
  if (scales != nullptr && t == 0) Lanes<T>::store_scale(scales + row, q.scale);
  finish_row<T>(u + row * rows.row4, out + base, blockDim.x, t, valid, r, q);
}

template <typename T, int V>
void launch_warp(const void* x, const void* u, void* out, T* scales, int nb, Rows rows, int levels,
                 cudaStream_t stream) {
  using Raw = typename Lanes<T>::Raw;
  const int grid = (nb + kRowsPerCta - 1) / kRowsPerCta;
  warp_quant_kernel<T, V><<<grid, kRowsPerCta * 32, 0, stream>>>(
      static_cast<const Raw*>(x), static_cast<const Raw*>(u), static_cast<Raw*>(out), scales, nb, rows, levels);
}

// nb rows of `block` over nodes of d elements each (a tile: d = block);
// scales may be null
template <typename T>
int launch(const void* x, const void* u, void* out, void* scales_, int nb, int block, int d, int bits,
           void* stream_) {
  using Raw = typename Lanes<T>::Raw;
  if (nb < 0 || block <= 0 || block % 128 != 0 || block > kMaxBlock || bits < 1 || bits > 8 || d <= 0 ||
      d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{(d + block - 1) / block, d / 4, block / 4};
  if (nb % rows.nbn != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  const int levels = (1 << bits) - 1;
  T* scales = static_cast<T*>(scales_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (block > kMaxWarpBlock) {
    cta_quant_kernel<T><<<nb, block / 4, 0, stream>>>(static_cast<const Raw*>(x), static_cast<const Raw*>(u),
                                                      static_cast<Raw*>(out), scales, rows, levels);
    return static_cast<int>(cudaGetLastError());
  }
  switch (block / 128) {  // V = block / 32 values a lane
    case 1: launch_warp<T, 4>(x, u, out, scales, nb, rows, levels, stream); break;
    case 2: launch_warp<T, 8>(x, u, out, scales, nb, rows, levels, stream); break;
    case 3: launch_warp<T, 12>(x, u, out, scales, nb, rows, levels, stream); break;
    case 4: launch_warp<T, 16>(x, u, out, scales, nb, rows, levels, stream); break;
    case 5: launch_warp<T, 20>(x, u, out, scales, nb, rows, levels, stream); break;
    case 6: launch_warp<T, 24>(x, u, out, scales, nb, rows, levels, stream); break;
    case 7: launch_warp<T, 28>(x, u, out, scales, nb, rows, levels, stream); break;
    default: launch_warp<T, 32>(x, u, out, scales, nb, rows, levels, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (nb, block) tiles, with their (nb,) scales
extern "C" int quantize_f32(const void* x, const void* u, void* out, void* scales, int nb, int block, int bits,
                            void* stream) {
  return launch<float>(x, u, out, scales, nb, block, block, bits, stream);
}

extern "C" int quantize_bf16(const void* x, const void* u, void* out, void* scales, int nb, int block, int bits,
                             void* stream) {
  return launch<__nv_bfloat16>(x, u, out, scales, nb, block, block, bits, stream);
}

// a node-stacked flat leaf (m, d), read and written in place, with the
// samples of its (nb, block) tiles, nb = m * ceil(d / block); no scales
extern "C" int quantize_leaf_f32(const void* x, const void* u, void* out, int nb, int block, int d, int bits,
                                 void* stream) {
  return launch<float>(x, u, out, nullptr, nb, block, d, bits, stream);
}

extern "C" int quantize_leaf_bf16(const void* x, const void* u, void* out, int nb, int block, int d, int bits,
                                  void* stream) {
  return launch<__nv_bfloat16>(x, u, out, nullptr, nb, block, d, bits, stream);
}
