// K4: the packed audit reduction, [C, R] bool -> [C, 1+k] int32.
//
//   out[c, 0]     = number of true cells in row c
//   out[c, 1..k]  = the first k true columns of row c, ascending, plus
//                   row_offset, -1 padded
//
// Replaces gatekeeper_tpu/ops/driver.py _packed_reduction, which on the TPU
// OR-ed W=64 blocks and ran two narrow stable top_ks.  Bit-equal to it.
// row_offset is 0 on one device; on a mesh each shard reduces its row slab
// and writes global rows, shard * slab + column, as the JAX package's
// shard_map bodies do after the reduction (ops/driver.py
// _fused_audit_mesh_fn, parallel/multihost.py multihost_capped_sweep).
//
// What bounds it: the count needs the whole row, so every mask byte is read
// once (C*R bytes; about 134 MB at C=1024, R=131072, about 40 us at
// 3.35 TB/s).  The output is C*(1+k)*4 bytes, small beside it.
//
// Design: one block of 256 threads per constraint row walks the row in
// ascending 4 KiB chunks; each thread loads 16 consecutive bytes (one
// 16-byte load where the row is 16-byte aligned), folds them to a 16-bit
// flag word and counts it with __popc.  A warp shuffle scan and a scan of
// the eight warp totals give each thread its exclusive rank; a thread whose
// rank is below k writes its true columns at their ranks.  The running
// total carries across chunks and ends as the count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BYTES = 16;  // per thread per chunk

__global__ void packed_reduction_kernel(const uint8_t* __restrict__ mask,
                                        int R, int k, int vec,
                                        int row_offset,
                                        int* __restrict__ out) {
  __shared__ int warp_sum[WARPS];
  const int c = blockIdx.x;
  const uint8_t* row = mask + (size_t)c * R;
  int* o = out + (size_t)c * (1 + k);
  for (int i = threadIdx.x; i < k; i += THREADS) o[1 + i] = -1;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int base = 0;  // true cells before this chunk (same in every thread)
  for (int start = 0; start < R; start += THREADS * BYTES) {
    const int beg = start + threadIdx.x * BYTES;
    unsigned bits = 0;
    if (vec && beg + BYTES <= R) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + beg);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if ((w[q] >> (8 * b)) & 0xffu) bits |= 1u << (4 * q + b);
    } else {
      for (int b = 0; b < BYTES; ++b)
        if (beg + b < R && row[beg + b]) bits |= 1u << b;
    }
    const int local = __popc(bits);
    int incl = local;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[wid] = incl;
    __syncthreads();
    if (wid == 0) {  // inclusive scan of the warp totals
      int t = lane < WARPS ? warp_sum[lane] : 0;
#pragma unroll
      for (int d = 1; d < WARPS; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += y;
      }
      if (lane < WARPS) warp_sum[lane] = t;
    }
    __syncthreads();
    int rank = base + (wid ? warp_sum[wid - 1] : 0) + incl - local;
    for (unsigned b = bits; b && rank < k; b &= b - 1) {
      o[1 + rank] = row_offset + beg + __ffs(b) - 1;
      ++rank;
    }
    base += warp_sum[WARPS - 1];
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
  if (threadIdx.x == 0) o[0] = base;
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gk_packed_reduction_launch(const uint8_t* mask, int C, int R,
                                          int k, int vec, int row_offset,
                                          int* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  packed_reduction_kernel<<<C, THREADS, 0, s>>>(mask, R, k, vec, row_offset,
                                                out);
  return cudaGetLastError();
}
