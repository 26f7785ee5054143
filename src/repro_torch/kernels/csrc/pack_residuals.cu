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
// MXU; on Hopper ballots and a direct store do it without the block x kpad
// product.  pack: one warp per row, 8 rows per CTA of 256 threads.  Lane l
// reads elements 4l..4l+3 of each 128-element chunk as one float4, so a
// chunk is one coalesced load for the warp, and up to 8 chunks (a row of
// 1,024) are loaded before any is ranked, so the row's loads are in flight
// together and the row is read once.  Within a chunk, survivors go in lane
// order and, within a lane, in element order: one __ballot_sync per element
// gives the survivors of the lower lanes (popc of the ballot under the
// lane mask), and the lane's own earlier elements come next, so each
// survivor's rank is known and it is stored straight to its slot.  The
// running base moves by the chunk's survivor count.  Then the lanes fill
// [nnz, kpad).  No shared memory, no CTA barrier.  At the main path's size
// a copy_ of the same bytes takes nearly as long (chip_smoke.py's copy_ms):
// so small a kernel is held by its launch, ramp and drain more than by its
// design.  unpack: one CTA of 256 threads per row zeroes a shared-memory
// row, atomicAdds each in-range slot into it (duplicate indices sum, as the
// one-hot product does) and writes the row out coalesced.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;           // unpack: threads a row
constexpr int kPackRowsPerCta = 8;      // pack: one row a warp
constexpr int kPackChunks = 8;          // pack: 128-element chunks held at once
constexpr int kMaxUnpackBlock = 12288;  // 48 KB of static-limit shared memory

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
  if (nb < 0 || block <= 0 || block > kMaxUnpackBlock || kpad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  unpack_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<float*>(out), block, kpad);
  return static_cast<int>(cudaGetLastError());
}
