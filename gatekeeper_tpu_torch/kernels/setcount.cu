// K3: the set-count comparison, bool[C, R].
//
//   orient 0:  cnt[c, r] = sum_p cmask[c,p] && !exists_k(kids[r,k] == cids[c,p]
//                                                        && kids[r,k] != PAD)
//   orient 1:  cnt[c, r] = sum_k kids[r,k] != PAD && !exists_p(cids[c,p] ==
//                                                   kids[r,k] && cmask[c,p])
//   out[c, r] = cnt[c, r] <op> n
//
// Orientation 0 counts a constraint's parameter elements missing from the
// review's key set; orientation 1 the review's keys missing from the
// parameters.  Replaces gatekeeper_tpu/ops/vexpr.py _eval_setcount, which
// unrolled P x K compares over [C, R] (P*K*2 launches in eager torch).
//
// What bounds it: C*R*P*K integer compares against writing the C*R output
// bytes.  At the main path's widths (P, K <= 8) the compares are a few
// hundred giga-operations a second of work at most, so the output write
// (memory) is the bound.
//
// Design: one thread per (c, r) cell; a block covers CT constraints x 128
// reviews.  The CT constraints' [P] ids and masks sit in shared memory; each
// thread reads its review's K ids (one row, L1-cached) and loops.  The
// per-cell count is setcount.cuh's, which K9 runs too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "setcount.cuh"

namespace {

constexpr int CT = 8;
constexpr int THREADS = 128;

__global__ void setcount_kernel(const int* __restrict__ cids,
                                const uint8_t* __restrict__ cmask, int C,
                                int P, const int* __restrict__ kids, int R,
                                int K, int pad, int orient, int op, int n,
                                uint8_t* __restrict__ out) {
  extern __shared__ int sh[];
  int* sid = sh;            // [CT, P]
  int* smask = sh + CT * P;  // [CT, P]
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  for (int i = threadIdx.x; i < nc * P; i += blockDim.x) {
    sid[i] = cids[(size_t)c0 * P + i];
    smask[i] = cmask[(size_t)c0 * P + i];
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int* kr = kids + (size_t)r * K;
  for (int j = 0; j < nc; ++j) {
    const int cnt = gk::setcount_count(sid + j * P, smask + j * P, P, kr, K,
                                       pad, orient);
    out[(size_t)(c0 + j) * R + r] = gk::setcount_compare(cnt, op, n);
  }
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gk_setcount_launch(const int* cids, const uint8_t* cmask,
                                  int C, int P, const int* kids, int R, int K,
                                  int pad, int orient, int op, int n,
                                  uint8_t* out, void* stream) {
  const size_t smem = (size_t)2 * CT * P * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        setcount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((R + THREADS - 1) / THREADS, (C + CT - 1) / CT);
  setcount_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      cids, cmask, C, P, kids, R, K, pad, orient, op, n, out);
  return cudaGetLastError();
}
