// K2: the string-predicate hit of a review-side operand, bool[C, N].
//
//   out[c, n] = negate ^ (tcode[n] == STRING && sid[n] >= 0 &&
//                         tableT[clip(sid[n], 0, V-1), idx[c]] != 0)
//
// N is R (a scalar column) or R*S (a slot column, flattened); idx[c] picks
// the constraint's row of host-precomputed predicate tables, kept
// transposed ([V, U]) so one string id's U bytes are contiguous.
//
// Replaces gatekeeper_tpu/ops/vexpr.py _eval_strpred, review-side branch:
// there a gather of transposed table rows per string id feeds a one-hot
// int8 einsum shaped for the TPU's matrix unit.  On the H100 the same
// function is a plain gather, with no matrix unit to feed.
//
// What bounds it: writing C*N output bytes, plus reading tcode and sid
// (5 bytes an element) and the U-byte table rows of the distinct ids.
//
// Design: one thread per element n, looping over a block's CT constraints
// (their table columns staged in shared memory).  The thread reads its
// element's table row once per constraint from the same cache line; the
// CT output rows are written coalesced along n.  The per-element test is
// strpred.cuh's, which K9 runs too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "strpred.cuh"

namespace {

constexpr int CT = 16;        // constraints per block
constexpr int THREADS = 256;  // elements per block

__global__ void strpred_kernel(const uint8_t* __restrict__ tableT, int V,
                               int U, const int* __restrict__ idx, int C,
                               const int8_t* __restrict__ tcode,
                               const int* __restrict__ sid, long long N,
                               int negate, uint8_t* __restrict__ out) {
  __shared__ int col[CT];
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  if (threadIdx.x < nc) col[threadIdx.x] = idx[c0 + threadIdx.x];
  __syncthreads();
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int s = sid[n];
  const int t = tcode[n];
  for (int j = 0; j < nc; ++j)
    out[(size_t)(c0 + j) * N + n] =
        gk::strpred_cell(tableT, V, U, col[j], t, s, negate != 0);
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gk_strpred_launch(const uint8_t* tableT, int V, int U,
                                 const int* idx, int C, const int8_t* tcode,
                                 const int* sid, long long N, int negate,
                                 uint8_t* out, void* stream) {
  dim3 grid((unsigned)((N + THREADS - 1) / THREADS), (C + CT - 1) / CT);
  strpred_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tableT, V, U, idx, C, tcode, sid, N, negate, out);
  return cudaGetLastError();
}
