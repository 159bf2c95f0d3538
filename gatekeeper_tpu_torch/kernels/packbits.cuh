// The review's bit pack: K10's body (packbits.cu), which K9 runs too in
// its review mode (program.cu), so that the two cannot drift apart:
// pack8 makes a packed byte of 8 column values, pack_byte packed byte t
// from memory.
//
//   byte t of uint8[2C, ceil(R/8)]: row i = t / ceil(R/8), byte j of it;
//   row i < C packs mask[i, 8j .. 8j+7], row C + i autoreject[i, ...];
//   column 8j is the most significant bit, the pad bits of a row's last
//   byte (R % 8 != 0) are 0.
//
// vec: both inputs 8-byte aligned and R a multiple of 8, so a byte's 8
// columns load as one little-endian 64-bit word (column 8j + b is byte b);
// otherwise the up to 8 bytes load one by one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gk {

// The packed byte of 8 column values, column 8j (v[0]) in the most
// significant bit, a nonzero value a 1.
__device__ __forceinline__ uint8_t pack8(const uint8_t v[8]) {
  unsigned byte = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (v[b]) byte |= 0x80u >> b;
  return (uint8_t)byte;
}

__device__ __forceinline__ uint8_t pack_byte(const uint8_t* mask,
                                             const uint8_t* autoreject, int C,
                                             int R, int vec, long long t) {
  const long long RB = (R + 7) / 8;
  const long long row = t / RB;
  const int col = 8 * (int)(t - row * RB);
  const uint8_t* src =
      (row < C ? mask + row * R : autoreject + (row - C) * R) + col;
  uint8_t v[8];
  if (vec) {
    const unsigned long long w =
        *reinterpret_cast<const unsigned long long*>(src);
#pragma unroll
    for (int b = 0; b < 8; ++b) v[b] = (uint8_t)(w >> (8 * b));
  } else {
    const int n = R - col < 8 ? R - col : 8;
#pragma unroll
    for (int b = 0; b < 8; ++b) v[b] = b < n ? src[b] : 0;
  }
  return pack8(v);
}

}  // namespace gk
