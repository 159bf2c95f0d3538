// K6: the resident row scatter.  Writes n dirty rows into every leaf of the
// device-resident audit pack in one launch:
//
//   for every leaf l and j < n:
//     dst_l[idx[j], ...] = src_l[j, ...]          (row_bytes_l bytes)
//
// The host stages everything in one buffer, copied over at once
// (ops/scatter.py staging_layout): the leaf table (destination pointer,
// the leaf's offset in a staged row, row bytes, unit width), the int64
// indices, the unit table (for each unit of a row: its leaf and its byte
// offset in the leaf's row), and the rows row-major, so that one dirty
// row's bytes of every leaf are contiguous.  Leaves may be of any dtype
// (bool, int8, int32, int64, float64) and of rank 1, 2 or 3: a row is
// row_bytes contiguous bytes either way.  A leaf's unit is the widest of
// 16, 8, 4, 2 and 1 bytes that divides its row bytes and its destination
// pointer; its offset in a staged row is aligned to it, and a staged row
// to 16 bytes, so every unit's load and store are aligned.  Duplicate
// indices carry identical rows, so whichever write lands last, the bytes
// are the same.
//
// Replaces gatekeeper_tpu/ops/driver.py _scatter_rows_impl, which there is
// one jitted tree_map of `.at[idx].set(rows)` over every leaf, bucketed in
// width so XLA does not recompile per dirty count.  Nothing here compiles
// per shape, so exactly the dirty rows are written.
//
// What bounds it: bytes.  It reads the staged rows once and writes them
// once (2 * n * sum(row_bytes)), plus the tables and the indices: about
// 0.25 MB at n = 256 rows of the 500-template pack, so at 3.35 TB/s the
// launch itself, not the copy, is the floor.  The kernel before this one
// ran a 64-thread block per (row, leaf), 43,148 blocks at 938 rows of 46
// leaves, most of them copying a few bytes one by one.
//
// Design: a few hundred blocks.  Each block copies the leaf table and the
// unit table into shared memory once; a warp takes one dirty row across
// all leaves (its index one broadcast load), a lane one unit at a time:
// a byte of a narrow or unaligned leaf, a 2-, 4-, 8- or 16-byte word where
// the row bytes and both addresses allow.  A lane issues the loads of
// UNROLL units before it stores any, and a warp's loads read one
// contiguous staged row, so they coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr long long MAX_BLOCKS = 1024;

// w bytes at p, w a unit width, into the low bytes of a 16-byte word
__device__ __forceinline__ uint4 load_unit(const uint8_t* p, int w) {
  uint4 v = make_uint4(0, 0, 0, 0);
  switch (w) {
    case 16: v = *reinterpret_cast<const uint4*>(p); break;
    case 8: {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      v.x = u.x;
      v.y = u.y;
      break;
    }
    case 4: v.x = *reinterpret_cast<const uint32_t*>(p); break;
    case 2: v.x = *reinterpret_cast<const uint16_t*>(p); break;
    default: v.x = *p;
  }
  return v;
}

__device__ __forceinline__ void store_unit(uint8_t* p, int w, uint4 v) {
  switch (w) {
    case 16: *reinterpret_cast<uint4*>(p) = v; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.x; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = (uint16_t)v.x; break;
    default: *p = (uint8_t)v.x;
  }
}

__global__ void __launch_bounds__(THREADS)
    scatter_rows_kernel(const uint8_t* __restrict__ base, int n_leaves,
                        int n_units, int n_rows, long long idx_off,
                        long long unit_off, long long rows_off,
                        long long stride) {
  extern __shared__ long long sh[];
  long long* tab = sh;                                    // [L, 4]
  int2* units = reinterpret_cast<int2*>(sh + 4LL * n_leaves);  // [U]
  const long long* g_tab = reinterpret_cast<const long long*>(base);
  const int2* g_units = reinterpret_cast<const int2*>(base + unit_off);
  for (int i = threadIdx.x; i < 4 * n_leaves; i += THREADS) tab[i] = g_tab[i];
  for (int i = threadIdx.x; i < n_units; i += THREADS) units[i] = g_units[i];
  __syncthreads();

  const long long* idx = reinterpret_cast<const long long*>(base + idx_off);
  const int lane = threadIdx.x & 31;
  for (long long j = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       j < n_rows; j += (long long)gridDim.x * WARPS) {
    const uint8_t* row = base + rows_off + j * stride;
    const long long r = idx[j];
    for (int u0 = lane; u0 < n_units; u0 += 32 * UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int u = u0 + 32 * k;
        if (u < n_units) {
          const int2 e = units[u];  // leaf, byte offset in its row
          const long long* t = tab + 4 * e.x;
          v[k] = load_unit(row + t[1] + e.y, (int)t[3]);
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int u = u0 + 32 * k;
        if (u < n_units) {
          const int2 e = units[u];
          const long long* t = tab + 4 * e.x;
          store_unit(reinterpret_cast<uint8_t*>(t[0]) + r * t[2] + e.y,
                     (int)t[3], v[k]);
        }
      }
    }
  }
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// base: the staged buffer on the card (ops/scatter.py stage_buffer);
// idx_off, unit_off, rows_off: byte offsets of the indices, the unit table
// and the rows in it; stride: the bytes of a staged row.
extern "C" int gk_scatter_launch(const uint8_t* base, int n_leaves,
                                 int n_units, int n_rows, long long idx_off,
                                 long long unit_off, long long rows_off,
                                 long long stride, void* stream) {
  if (n_leaves <= 0 || n_units <= 0 || n_rows <= 0) return 0;
  const size_t smem = 32 * (size_t)n_leaves + 8 * (size_t)n_units;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scatter_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  long long blocks = (n_rows + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  scatter_rows_kernel<<<(unsigned)blocks, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      base, n_leaves, n_units, n_rows, idx_off, unit_off, rows_off, stride);
  return cudaGetLastError();
}
