// K6: the resident row scatter.  Writes n dirty rows into every leaf of the
// device-resident audit pack in one launch:
//
//   for every leaf l and j < n:
//     dst_l[idx[j], ...] = src_l[j, ...]          (row_bytes_l bytes)
//
// The host gathers each leaf's dirty rows into one staging buffer, which
// also holds a table of (dst pointer, src offset, row bytes) per leaf and
// the row indices; one host-to-device copy brings it over.  Leaves may be of
// any dtype (bool, int8, int32, int64, float64) and of rank 1, 2 or 3: a
// row is row_bytes contiguous bytes either way.  Duplicate indices carry
// identical rows, so whichever write lands last, the bytes are the same.
//
// Replaces gatekeeper_tpu/ops/driver.py _scatter_rows_impl, which there is
// one jitted tree_map of `.at[idx].set(rows)` over every leaf, bucketed in
// width so XLA does not recompile per dirty count.  Nothing here compiles
// per shape, so exactly the dirty rows are written.
//
// What bounds it: bytes.  It reads the staged rows once and writes them
// once (2 * n * sum(row_bytes)), plus the table and the indices: about
// 0.25 MB at n = 256 rows of the 500-template pack, so at 3.35 TB/s the
// launch itself, not the copy, is the floor.
//
// Design: one block per (row, leaf), one warp-sized block of threads
// copying 4-byte words where the row length and both addresses allow it,
// else bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;

__global__ void scatter_rows_kernel(const long long* __restrict__ table,
                                    const long long* __restrict__ idx,
                                    const uint8_t* __restrict__ base) {
  const int j = blockIdx.x;  // dirty row
  const int l = blockIdx.y;  // leaf
  const long long rb = table[3 * l + 2];
  uint8_t* dst = reinterpret_cast<uint8_t*>(table[3 * l]) + idx[j] * rb;
  const uint8_t* src = base + table[3 * l + 1] + (long long)j * rb;
  if ((rb & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (long long w = threadIdx.x; w < (rb >> 2); w += THREADS) d[w] = s[w];
  } else {
    for (long long b = threadIdx.x; b < rb; b += THREADS) dst[b] = src[b];
  }
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gk_scatter_launch(const long long* table, const long long* idx,
                                 const uint8_t* base, int n_leaves, int n_rows,
                                 void* stream) {
  dim3 grid((unsigned)n_rows, (unsigned)n_leaves);
  scatter_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, idx, base);
  return cudaGetLastError();
}
