// Sparse residual pack / unpack for the wire codec, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pack_residuals.py, pack_sparse_blocks (kernel
// body _pack_kernel) and unpack_sparse_blocks (kernel body _unpack_kernel).
// Plain versions: repro_torch/kernels/pack_residuals.py,
// pack_sparse_blocks_ref / unpack_sparse_blocks_ref /
// unpack_sparse_blocks_into_ref.
//
// pack: (nb, block) f32 -> vals (nb, kpad) f32, idx (nb, kpad) i32.  The
// survivors of a row (x != 0: -0.0 is dropped, NaN kept) go to slots in
// ascending lane order, slot = exclusive rank among the row's survivors;
// slots [nnz, kpad) hold 0.0 and the sentinel index `block`; survivors with
// rank >= kpad are dropped.
// unpack: vals[j] is summed into lane idx[j] of a zeroed (block,) f32 row;
// an index outside [0, block) writes nothing.  Two entry points:
// - the tile, (nb, kpad) records -> the (nb, block) f32 rows;
// - the leaf, (lead * nb, kpad) records -> a (lead, d) leaf of T (f32 or
//   bf16), nb = ceil(d / block): record row r = rank * nb + b fills lanes
//   [b * block, min((b + 1) * block, d)) of rank's slice; the padded tail
//   of a rank's last block is dropped.  Each value is rounded to T; with a
//   base, the leaf is base + that value, added in f32 (__fadd_rn, never an
//   FMA) and rounded once to T, on every lane, so an empty lane over a
//   -0.0 base gives +0.0 as torch.add does.
//
// Bound on an H100 (3.35 TB/s).  pack at the main path's shape (1,985,
// 1,024), kpad = 256: reads the tile (8.1 MB) and writes the records (4.1
// MB), >= 3.6 us.  unpack at the fused exchange's stacked shape (19,850
// rows, kpad 256, block 1,024): the tile reads 40.7 MB of records and
// writes 81.3 MB, >= 36.4 us; the leaf entry with a base reads the base
// too, 203.3 MB, >= 60.7 us.  Both directions are pure data movement: a
// few integer operations and one shared-memory atomic a record.
//
// Design.  The TPU kernels route values through a one-hot matmul on the
// MXU; on Hopper ballots, a direct store and shared-memory atomics do it
// without the block x kpad product.
// pack: one warp per row, 8 rows per CTA of 256 threads.  Lane l reads
// elements 4l..4l+3 of each 128-element chunk as one float4, so a chunk is
// one coalesced load for the warp, and up to 8 chunks (a row of 1,024) are
// loaded before any is ranked, so the row's loads are in flight together
// and the row is read once.  Within a chunk, survivors go in lane order
// and, within a lane, in element order: one __ballot_sync per element gives
// the survivors of the lower lanes (popc of the ballot under the lane
// mask), and the lane's own earlier elements come next, so each survivor's
// rank is known and it is stored straight to its slot.  The running base
// moves by the chunk's survivor count.  Then the lanes fill [nnz, kpad).
// No shared memory, no CTA barrier.
// unpack (redesigned): one warp per row, up to 8 rows per CTA (fewer above
// block 1,024, so a CTA's rows hold about 32 KB; at block 12,288 one row,
// 48.2 KB of dynamic shared memory, allowed by cudaFuncSetAttribute), each
// warp on its own shared-memory row, synchronised by __syncwarp only: no
// CTA barrier ties one row's phases to another's.  A lane reads its
// records as 16-byte vectors (4 values, 4 indices; kpad = 256 is two of
// each a lane), issues the first 256 records' loads before it zeroes the
// row, then atomicAdds each in-range value into the row (duplicate
// indices sum, as the one-hot product does).  The row goes out as 16-byte
// vectors (4 f32 or 8 bf16 values).  Onto a base, a lane loads its first 8
// base vectors (a whole row of 1,024 f32 or 2,048 bf16) into registers
// with its records, before the scatter, so the base's bytes are in flight
// with the records' (read after the scatter instead, they left the kernel
// at 85 us against 70 us at the stacked shape: tools/ab_kernels.py, H100
// 80GB HBM3, 700 W); the rest of a larger row is read as it goes out.  A
// leaf row whose first element is not on a 16-byte boundary (d % 4 != 0
// in f32, d % 8 != 0 in bf16) is scattered into the shared row shifted by
// that misalignment, so its vectors still line up with the leaf's; the
// partial vectors at either end are written value by value.  The tile
// entry is the leaf kernel on a leaf of one block a row.  At 8 rows and
// 33 KB a CTA, 6 CTAs fit an SM's shared memory: 48 rows in flight, each
// with 2 KB of record loads outstanding (onto a base, the registers allow
// fewer CTAs, with 6 KB a row outstanding).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kPackRowsPerCta = 8;      // pack: one row a warp
constexpr int kPackChunks = 8;          // pack: 128-element chunks held at once
constexpr int kUnpackMaxRows = 8;       // unpack: rows (warps) a CTA
constexpr int kUnpackCtaLanes = 8192;   // unpack: a CTA's rows hold about this many lanes
constexpr int kUnpackHeld = 2;          // unpack: 16-byte record vectors a lane holds at once
constexpr int kRowPad = 8;              // unpack: spare lanes of a shared row (the leaf's misalignment)
constexpr int kBaseHeld = 8;            // unpack onto a base: base vectors a lane loads before the scatter
constexpr int kMaxUnpackBlock = 12288;  // unpack: the largest block held on the card

__global__ void __launch_bounds__(kPackRowsPerCta * 32)
    pack_kernel(const float4* __restrict__ x, float* __restrict__ vals,
                int* __restrict__ idx, int nb, int block, int kpad) {
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kPackRowsPerCta + (threadIdx.x >> 5);
  if (row >= static_cast<size_t>(nb)) return;
  const int chunks = block >> 7;
  const float4* xr = x + row * (block >> 2);
  float* vr = vals + row * kpad;
  int* ir = idx + row * kpad;
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one

  unsigned base = 0;  // survivors of the chunks before
  for (int c0 = 0; c0 < chunks; c0 += kPackChunks) {
    float4 v[kPackChunks];
#pragma unroll
    for (int j = 0; j < kPackChunks; ++j)
      if (c0 + j < chunks) v[j] = xr[(c0 + j) * 32 + lane];
#pragma unroll
    for (int j = 0; j < kPackChunks; ++j) {
      if (c0 + j >= chunks) break;  // uniform across the warp
      const float e[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      unsigned r = base;
      unsigned n = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned ballot = __ballot_sync(0xffffffffu, e[q] != 0.0f);
        r += __popc(ballot & below);
        n += __popc(ballot);
      }
      const int lane0 = (c0 + j) * 128 + 4 * lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e[q] != 0.0f) {
          if (r < static_cast<unsigned>(kpad)) {
            vr[r] = e[q];
            ir[r] = lane0 + q;
          }
          ++r;
        }
      }
      base += n;
    }
  }
  for (unsigned s = base + lane; s < static_cast<unsigned>(kpad); s += 32) {
    vr[s] = 0.0f;
    ir[s] = block;
  }
}

// One leaf value as a float, and a float rounded to the leaf's type.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(unsigned short v) { return __bfloat162float(__ushort_as_bfloat16(v)); }
template <typename S>
__device__ __forceinline__ S from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ unsigned short from_float<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The leaf's storage type: f32 as float, bf16 as its 16 bits.
template <typename T>
struct Storage {
  using type = float;
};
template <>
struct Storage<__nv_bfloat16> {
  using type = unsigned short;
};

// A 16-byte vector of leaf values: 4 f32 or 8 bf16, loaded and stored as
// one 16-byte access (values in registers, no union in memory).  The
// stores and the late base loads go through __stcg / __ldg: written as
// plain vector accesses, nvcc split them into four 4-byte ones in the loop
// that also holds the partial-vector path (cuobjdump -sass: STG.E, not
// STG.E.128).
__device__ __forceinline__ void from16(uint4 w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void from16(uint4 w, unsigned short (&v)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = static_cast<unsigned short>(u[j] & 0xffffu);
    v[2 * j + 1] = static_cast<unsigned short>(u[j] >> 16);
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(unsigned short* p, const unsigned short (&v)[8]) {
  uint4 w;
  w.x = v[0] | (static_cast<unsigned>(v[1]) << 16);
  w.y = v[2] | (static_cast<unsigned>(v[3]) << 16);
  w.z = v[4] | (static_cast<unsigned>(v[5]) << 16);
  w.w = v[6] | (static_cast<unsigned>(v[7]) << 16);
  __stcg(reinterpret_cast<uint4*>(p), w);
}

// u rounded to the leaf's type, then (with a base) base + it in f32 with no
// FMA, rounded once: base + unpacked.to(dtype) as PyTorch computes it.
template <typename S, bool kBase>
__device__ __forceinline__ S leaf_value(float u, S b) {
  const S q = from_float<S>(u);
  if constexpr (kBase) return from_float<S>(__fadd_rn(to_float(b), to_float(q)));
  return q;
}

__device__ __forceinline__ void scatter(float* row, int block, float v, int i) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(block)) atomicAdd(row + i, v);
}

// Vector t of a row out: shared slots [t * kVec, (t + 1) * kVec), leaf
// elements from e_base + t * kVec (a 16-byte boundary).  ``held`` is its
// base vector where ``have`` (loaded earlier), else it is loaded here.
template <typename S, bool kBase>
__device__ __forceinline__ void put_vector(const float* srow, const S* __restrict__ base, S* __restrict__ out,
                                           size_t e_base, int t, int shift, int n, uint4 held, bool have) {
  constexpr int kVec = 16 / sizeof(S);
  const int s0 = t * kVec;
  const size_t e0 = e_base + s0;
  if (s0 >= shift && s0 + kVec <= shift + n) {
    float u[kVec];
#pragma unroll
    for (int q = 0; q < kVec; q += 4) {
      const float4 f = *reinterpret_cast<const float4*>(srow + s0 + q);
      u[q] = f.x;
      u[q + 1] = f.y;
      u[q + 2] = f.z;
      u[q + 3] = f.w;
    }
    S bv[kVec] = {}, ov[kVec];
    if constexpr (kBase) from16(have ? held : __ldg(reinterpret_cast<const uint4*>(base + e0)), bv);
#pragma unroll
    for (int q = 0; q < kVec; ++q) ov[q] = leaf_value<S, kBase>(u[q], kBase ? bv[q] : S(0));
    store16(out + e0, ov);
  } else {  // a partial vector at either end of a misaligned or ragged row
    for (int q = 0; q < kVec; ++q) {
      const int s = s0 + q;
      if (s < shift || s >= shift + n) continue;
      out[e0 + q] = leaf_value<S, kBase>(srow[s], kBase ? base[e0 + q] : S(0));
    }
  }
}

template <typename S, bool kBase>
__global__ void __launch_bounds__(kUnpackMaxRows * 32)
    unpack_kernel(const float4* __restrict__ vals, const int4* __restrict__ idx,
                  const S* __restrict__ base, S* __restrict__ out, int rows, int nb, int d,
                  int block, int kpad) {
  extern __shared__ float4 s_rows[];
  constexpr int kVec = 16 / sizeof(S);  // leaf values a 16-byte vector
  constexpr int kHeld = kBase ? kBaseHeld : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // no CTA barrier below
  const int rank = row / nb;
  const int b = row - rank * nb;
  const size_t first = static_cast<size_t>(rank) * d + static_cast<size_t>(b) * block;
  const int n = min(block, d - b * block);             // lanes that land in the leaf
  const int shift = static_cast<int>(first % kVec);    // lane l sits at shared slot l + shift
  const size_t e_base = first - shift;                 // the leaf element at shared slot 0
  const int nv = (shift + n + kVec - 1) / kVec;        // 16-byte vectors the row touches
  const int stride = block + kRowPad;
  float* srow = reinterpret_cast<float*>(s_rows) + static_cast<size_t>(warp) * stride;

  // records: kpad / 4 vectors a row, a multiple of 32 (kpad % 128 == 0)
  const int nvec = kpad >> 2;
  const float4* vr = vals + static_cast<size_t>(row) * nvec;
  const int4* ir = idx + static_cast<size_t>(row) * nvec;
  uint4 held[kHeld > 0 ? kHeld : 1];
  for (int c0 = 0; c0 < nvec; c0 += 32 * kUnpackHeld) {
    float4 v[kUnpackHeld];
    int4 ix[kUnpackHeld];
#pragma unroll
    for (int h = 0; h < kUnpackHeld; ++h) {
      if (c0 + 32 * h < nvec) {  // uniform across the warp
        v[h] = vr[c0 + 32 * h + lane];
        ix[h] = ir[c0 + 32 * h + lane];
      }
    }
    if (c0 == 0) {  // the first base vectors and the zeroed row while the first loads are in flight
#pragma unroll
      for (int j = 0; j < kHeld; ++j) {
        const int s0 = (lane + 32 * j) * kVec;
        if (s0 >= shift && s0 + kVec <= shift + n) held[j] = *reinterpret_cast<const uint4*>(base + e_base + s0);
      }
      for (int j = lane; j < (stride >> 2); j += 32)
        reinterpret_cast<float4*>(srow)[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      __syncwarp();
    }
#pragma unroll
    for (int h = 0; h < kUnpackHeld; ++h) {
      if (c0 + 32 * h >= nvec) break;
      float* r = srow + shift;
      scatter(r, block, v[h].x, ix[h].x);
      scatter(r, block, v[h].y, ix[h].y);
      scatter(r, block, v[h].z, ix[h].z);
      scatter(r, block, v[h].w, ix[h].w);
    }
  }
  __syncwarp();

  int t = lane;
#pragma unroll
  for (int j = 0; j < kHeld; ++j, t += 32)
    if (t < nv) put_vector<S, kBase>(srow, base, out, e_base, t, shift, n, held[j], true);
#pragma unroll 4
  for (; t < nv; t += 32) put_vector<S, kBase>(srow, base, out, e_base, t, shift, n, uint4{}, false);
}

template <typename S, bool kBase>
int unpack_rows(const void* vals, const void* idx, const void* base, void* out, int rows, int nb,
                int d, int block, int kpad, int per_cta, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(per_cta) * (block + kRowPad) * sizeof(float);
  if (smem > 48 * 1024) {  // above the static limit: dynamic shared memory, asked for
    const cudaError_t e = cudaFuncSetAttribute(unpack_kernel<S, kBase>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (rows + per_cta - 1) / per_cta;
  unpack_kernel<S, kBase><<<grid, per_cta * 32, smem, stream>>>(
      static_cast<const float4*>(vals), static_cast<const int4*>(idx), static_cast<const S*>(base),
      static_cast<S*>(out), rows, nb, d, block, kpad);
  return static_cast<int>(cudaGetLastError());
}

// (lead * nb, kpad) records -> the (lead, d) leaf ``out`` (base + the
// unpacked values where ``base`` is not null).  Every pointer 16-byte
// aligned.
template <typename T>
int unpack_launch(const void* vals, const void* idx, const void* base, void* out, int lead, int d,
                  int block, int kpad, void* stream) {
  using S = typename Storage<T>::type;
  if (lead < 0 || d < 0 || block <= 0 || block % 128 != 0 || block > kMaxUnpackBlock || kpad <= 0 ||
      kpad % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (d + block - 1) / block;
  const long long rows = static_cast<long long>(lead) * nb;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = kUnpackCtaLanes / block;  // rows a CTA: 8 up to block 1,024, 1 from 8,192
  const int per_cta = fit < 1 ? 1 : (fit > kUnpackMaxRows ? kUnpackMaxRows : fit);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (base != nullptr)
    return unpack_rows<S, true>(vals, idx, base, out, static_cast<int>(rows), nb, d, block, kpad, per_cta, st);
  return unpack_rows<S, false>(vals, idx, base, out, static_cast<int>(rows), nb, d, block, kpad, per_cta, st);
}

}  // namespace

extern "C" int pack_sparse_blocks_f32(const void* x, void* vals, void* idx, int nb,
                                      int block, int kpad, void* stream) {
  if (nb < 0 || block <= 0 || block % 128 != 0 || kpad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  const int grid = (nb + kPackRowsPerCta - 1) / kPackRowsPerCta;
  pack_kernel<<<grid, kPackRowsPerCta * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float*>(vals), static_cast<int*>(idx), nb,
      block, kpad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_sparse_blocks_f32(const void* vals, const void* idx, void* out,
                                        int nb, int block, int kpad, void* stream) {
  return unpack_launch<float>(vals, idx, nullptr, out, nb, block, block, kpad, stream);
}

extern "C" int unpack_sparse_blocks_leaf_f32(const void* vals, const void* idx, const void* base,
                                             void* out, int lead, int d, int block, int kpad,
                                             void* stream) {
  return unpack_launch<float>(vals, idx, base, out, lead, d, block, kpad, stream);
}

extern "C" int unpack_sparse_blocks_leaf_bf16(const void* vals, const void* idx, const void* base,
                                              void* out, int lead, int d, int block, int kpad,
                                              void* stream) {
  return unpack_launch<__nv_bfloat16>(vals, idx, base, out, lead, d, block, kpad, stream);
}
