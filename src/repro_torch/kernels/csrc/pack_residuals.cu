// Sparse residual pack / unpack for the wire codec, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pack_residuals.py, pack_sparse_blocks (kernel
// body _pack_kernel) and unpack_sparse_blocks (kernel body _unpack_kernel).
// Plain versions: repro_torch/kernels/pack_residuals.py,
// pack_sparse_blocks_ref / unpack_sparse_blocks_ref.
//
// pack: (nb, block) f32 -> vals (nb, kpad) f32, idx (nb, kpad) i32.  The
// survivors of a row (x != 0: -0.0 is dropped, NaN kept) go to slots in
// ascending lane order, slot = exclusive rank among the row's survivors;
// slots [nnz, kpad) hold 0.0 and the sentinel index `block`; survivors with
// rank >= kpad are dropped.
// unpack: vals[j] is summed into lane idx[j] of a zeroed (block,) f32 row;
// an index outside [0, block) writes nothing.
//
// Bound on an H100 (3.35 TB/s), at the main path's shape (1,985, 1,024),
// kpad = 256: pack reads the tile (8.1 MB) and writes the records (4.1 MB),
// >= 3.6 us; unpack the reverse, the same bytes.  Both are pure data
// movement.
//
// Design.  The TPU kernel routes survivors through a one-hot matmul on the
// MXU; on Hopper a scan and a direct store do it without the block x kpad
// product.  pack: one CTA of 256 threads per row; each thread owns
// ceil(block / 256) contiguous lanes (4 at block 1024, one 16-byte span) and
// counts its survivors; an exclusive block-wide scan (warp shuffles, then
// one pass over the 8 warp totals in shared memory) gives each thread its
// first rank; a second pass over its lanes (now in L1) stores the survivors
// at their ranks; then the threads fill [nnz, kpad).  unpack: one CTA of 256
// threads per row zeroes a shared-memory row, atomicAdds each in-range slot
// into it (duplicate indices sum, as the one-hot product does) and writes
// the row out coalesced.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxUnpackBlock = 12288;  // 48 KB of static-limit shared memory

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const float* __restrict__ x, float* __restrict__ vals,
                int* __restrict__ idx, int block, int kpad) {
  __shared__ unsigned s_warp[kWarps];
  const size_t row = blockIdx.x;
  const float* xr = x + row * block;
  float* vr = vals + row * kpad;
  int* ir = idx + row * kpad;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int per = (block + kThreads - 1) / kThreads;
  const int begin = min(tid * per, block);
  const int end = min(begin + per, block);

  unsigned c = 0;
  for (int l = begin; l < end; ++l) c += xr[l] != 0.0f ? 1u : 0u;

  // inclusive scan within the warp
  unsigned inc = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += n;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kWarps ? s_warp[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned n = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += n;
    }
    if (lane < kWarps) s_warp[lane] = w;  // inclusive warp offsets
  }
  __syncthreads();
  const unsigned nnz = s_warp[kWarps - 1];
  unsigned r = (warp > 0 ? s_warp[warp - 1] : 0u) + inc - c;  // exclusive rank

  for (int l = begin; l < end; ++l) {
    const float v = xr[l];
    if (v != 0.0f) {
      if (r < static_cast<unsigned>(kpad)) {
        vr[r] = v;
        ir[r] = l;
      }
      ++r;
    }
  }
  for (unsigned s = nnz + tid; s < static_cast<unsigned>(kpad); s += kThreads) {
    vr[s] = 0.0f;
    ir[s] = block;
  }
}

__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                  float* __restrict__ out, int block, int kpad) {
  __shared__ float s_row[kMaxUnpackBlock];
  const size_t row = blockIdx.x;
  const float* vr = vals + row * kpad;
  const int* ir = idx + row * kpad;
  float* outr = out + row * block;
  const int tid = threadIdx.x;

  for (int l = tid; l < block; l += kThreads) s_row[l] = 0.0f;
  __syncthreads();
  for (int s = tid; s < kpad; s += kThreads) {
    const int i = ir[s];
    if (i >= 0 && i < block) atomicAdd(&s_row[i], vr[s]);
  }
  __syncthreads();
  for (int l = tid; l < block; l += kThreads) outr[l] = s_row[l];
}

}  // namespace

extern "C" int pack_sparse_blocks_f32(const void* x, void* vals, void* idx, int nb,
                                      int block, int kpad, void* stream) {
  if (nb < 0 || block <= 0 || kpad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  pack_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx),
      block, kpad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int unpack_sparse_blocks_f32(const void* vals, const void* idx, void* out,
                                        int nb, int block, int kpad, void* stream) {
  if (nb < 0 || block <= 0 || block > kMaxUnpackBlock || kpad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  unpack_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<float*>(out), block, kpad);
  return static_cast<int>(cudaGetLastError());
}
