// K5: the delta gather of the incremental audit, int8[C, 2w].
//
//   out[c, j]     = mask[c, idx[j]]     j < w   (before-columns)
//   out[c, w + j] = fresh[c, j]         j < w   (after-columns)
//
// mask is the full sweep's resident bool[C, R] candidate mask; idx the w
// dirty rows (a power of two >= 8, the last row repeated as padding);
// fresh the bool[C, w] mask of the same rows evaluated now.
//
// Replaces gatekeeper_tpu/ops/driver.py _delta_fn's gather and
// concatenation (`concatenate([mask_dev[:, idx].astype(int8),
// new.astype(int8)], axis=1)`), which there is fused into one jitted
// dispatch with the evaluation of the dirty slice.  On one card K9's delta
// mode (program.cu) writes the same columns in K9's launch; this kernel
// runs where K9 does not (no program group has rows), past
// ops/program.py DELTA_IN_K9_MAX_ROWS rows, and under a mesh, on each
// owning shard's slab of the resident mask.
//
// What bounds it: the launch.  Its bytes are C*w gathered mask bytes, C*w
// read from fresh and 2*C*w written, with w indices: about 1 MB at
// C = 1024, w = 256, 0.3 us at 3.35 TB/s, far under a launch.
//
// Design: one thread per output cell, the c-major output written
// coalesced; the gather reads one byte from each of w columns of a mask
// row, so neighbouring threads touch different cache sectors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void delta_columns_kernel(const uint8_t* __restrict__ mask, int C,
                                     int R, const int* __restrict__ idx,
                                     int w, const uint8_t* __restrict__ fresh,
                                     int8_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long total = (long long)C * 2 * w;
  if (t >= total) return;
  const int c = (int)(t / (2 * w));
  const int j = (int)(t - (long long)c * 2 * w);
  const uint8_t v = j < w ? mask[(size_t)c * R + idx[j]]
                          : fresh[(size_t)c * w + (j - w)];
  out[t] = v != 0;
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gk_delta_launch(const uint8_t* mask, int C, int R,
                               const int* idx, int w, const uint8_t* fresh,
                               int8_t* out, void* stream) {
  const long long total = (long long)C * 2 * w;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  delta_columns_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(mask, C, R, idx,
                                                              w, fresh, out);
  return cudaGetLastError();
}
