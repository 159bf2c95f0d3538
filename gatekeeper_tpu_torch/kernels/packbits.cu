// K10: the bit-packed review download, two bool[C, R] -> uint8[2C, ceil(R/8)].
//
//   out[i, j]     = mask[i, 8j .. 8j+7] packed, column 8j in the most
//                   significant bit (bitorder 'big'), for i < C
//   out[C + i, j] = autoreject[i, 8j .. 8j+7] packed the same way
//
// The unused low bits of the last byte of a row are 0 when R % 8 != 0.
//
// Replaces gatekeeper_tpu/ops/driver.py _packed_variant, whose fused_packed
// ran jnp.packbits(jnp.concatenate([mask, autoreject], 0), axis=1) inside
// the review's jitted dispatch, so the review's two masks leave the device
// as one array an eighth of their size.  Bit-equal to it.  The kernel reads
// both inputs where they lie: no concatenated copy is made first.
//
// What bounds it: every mask byte is read once and every packed byte
// written once, 2*C*R + 2*C*ceil(R/8) bytes.  At a review's call (C = 1024
// group rows, R = 8) that is 18 KiB, about 0.006 us at 3.35 TB/s: the
// launch, not the work, sets its time.  The test a cell costs one integer
// operation, far below the bytes.
//
// Design: one thread per output byte (packbits.cuh's pack_byte, which K9
// runs too in its review mode).  Where both inputs are 8-byte aligned and
// R is a multiple of 8, a thread loads its 8 columns as one 64-bit word
// and tests each byte; otherwise it reads the up to 8 bytes one by one.
// Neighbouring threads read neighbouring 8-byte groups, so a warp's loads
// coalesce along a row.  A grid-stride loop covers any 2C * ceil(R/8).
//
// A review's pack runs inside K9's launch (program.cu, review mode); this
// launch packs only a review whose side has no program group with rows,
// where K9 is not launched.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packbits.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 65535;

__global__ void packbits_kernel(const uint8_t* __restrict__ mask,
                                const uint8_t* __restrict__ autoreject,
                                int C, int R, int vec,
                                uint8_t* __restrict__ out) {
  const long long total = 2LL * C * ((R + 7) / 8);
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
       t < total; t += (long long)gridDim.x * THREADS)
    out[t] = gk::pack_byte(mask, autoreject, C, R, vec, t);
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gk_packbits_launch(const uint8_t* mask,
                                  const uint8_t* autoreject, int C, int R,
                                  int vec, uint8_t* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = 2LL * C * ((R + 7) / 8);
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  packbits_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(mask, autoreject, C,
                                                       R, vec, out);
  return cudaGetLastError();
}
