// K7: the provider key table of one join plan, (uk, uc) int32, each [N].
//
//   uk[0..u)  = the distinct keys of the participating rows, ascending
//   uc[0..u)  = for each, the number of distinct rows that provide it
//   uk[u..N)  = KEY_INVALID (2^31 - 1), uc[u..N) = 0
//
// A row participates when valid, of the plan's remote kind and in its
// scope (namespaced: ns_empty false; cluster: ns_empty true).  Its keys are
// sid[r, 0..S) where mask (if any) is set and the id is >= 0; a key the row
// holds twice counts once.  N = R * S (S = 1 for a scalar key column).
//
// Replaces gatekeeper_tpu/ops/joinkernel.py provider_key_table on one device
// (with row_distinct_slot_keys and compact_key_table, weight 1), which on
// the TPU sorted the row-sorted keys and segment-reduced the runs.  The
// output is bit-equal to it.
//
// What bounds it: bytes.  It reads each row's three review fields (6 bytes)
// and S key ids and mask bytes (5 bytes each), and writes 8 bytes for each
// of the N table entries: about 3.4 MB at R = 131072, S = 2, about 1 us at
// 3.35 TB/s.  In practice three launches and a single-block scan over the
// vocabulary bound it.
//
// Design: key ids are interned ids in [0, V), V the interner's size when
// the sweep was packed, passed from the host.  So no sort: (1) the count
// array [V] is zeroed; (2) one thread per row fills its N-table entries
// with the empty tail, tests participation, drops the keys it already
// counted among its own earlier slots (the row's S ids are re-read from
// L1) and atomicAdds 1 per distinct key; integer atomics, so the result
// does not depend on their order; (3) one block of 1024 threads walks
// [V] in ascending chunks of 8 ids a thread, and a warp shuffle scan plus
// a scan of the 32 warp totals gives each nonzero count its rank, as K4
// ranks rows; it writes (id, count) at that rank.  Ids outside [0, V) are
// not counted: the wrapper's caller guarantees there are none.
//
// The merge (gk_joinkeys_merge_launch).  On a mesh each shard builds its
// slab's table with the launcher above; the tables of every shard,
// concatenated on one device ([N] = W tables), merge into the table of the
// whole row axis.  This replaces the all_gather and second
// compact_key_table(keys, counts) of gatekeeper_tpu/ops/joinkernel.py
// provider_key_table (:262-267), bit-equal to it for shard tables (a valid
// key's count is at least 1).  Bound: bytes, the [N] tables read and the
// [N] merged table written, 16 N bytes, and the [V] counts.  Design: the
// same count array, a thread per entry adding its count (not 1) with an
// integer atomic, then the compact pass above.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KEY_INVALID = 2147483647;
constexpr int ROW_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int ITEMS = 8;  // vocabulary ids per thread per chunk

__global__ void count_kernel(const uint8_t* __restrict__ valid,
                             const int* __restrict__ kind,
                             const uint8_t* __restrict__ ns_empty,
                             int kind_id, int namespaced,
                             const int* __restrict__ sid,
                             const uint8_t* __restrict__ mask, int R, int S,
                             int V, int* __restrict__ counts,
                             int* __restrict__ uk, int* __restrict__ uc) {
  const int r = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t base = (size_t)r * S;
  for (int j = 0; j < S; ++j) {
    uk[base + j] = KEY_INVALID;
    uc[base + j] = 0;
  }
  const bool part = valid[r] && kind[r] == kind_id &&
                    ((ns_empty[r] != 0) != (namespaced != 0));
  if (!part) return;
  const int* row = sid + base;
  const uint8_t* m = mask ? mask + base : nullptr;
  for (int j = 0; j < S; ++j) {
    const int k = row[j];
    if (k < 0 || k >= V || (m && !m[j])) continue;
    bool seen = false;
    for (int i = 0; i < j && !seen; ++i) seen = row[i] == k && (!m || m[i]);
    if (!seen) atomicAdd(counts + k, 1);
  }
}

__global__ void merge_count_kernel(const int* __restrict__ in_uk,
                                   const int* __restrict__ in_uc, int N, int V,
                                   int* __restrict__ counts,
                                   int* __restrict__ uk, int* __restrict__ uc) {
  const int i = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (i >= N) return;
  uk[i] = KEY_INVALID;
  uc[i] = 0;
  const int k = in_uk[i];
  const int w = in_uc[i];
  if (k >= 0 && k < V && w != 0) atomicAdd(counts + k, w);
}

__global__ void compact_kernel(const int* __restrict__ counts, int V,
                               int* __restrict__ uk, int* __restrict__ uc) {
  __shared__ int warp_sum[SCAN_WARPS];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int base = 0;  // nonzero counts before this chunk (same in every thread)
  for (int start = 0; start < V; start += SCAN_THREADS * ITEMS) {
    const int beg = start + threadIdx.x * ITEMS;
    int c[ITEMS];
    if (beg + ITEMS <= V) {  // counts is 256-byte aligned, beg a multiple of 8
      const int4 a = *reinterpret_cast<const int4*>(counts + beg);
      const int4 b = *reinterpret_cast<const int4*>(counts + beg + 4);
      c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
      c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
    } else {
#pragma unroll
      for (int b = 0; b < ITEMS; ++b) c[b] = beg + b < V ? counts[beg + b] : 0;
    }
    int local = 0;
#pragma unroll
    for (int b = 0; b < ITEMS; ++b) local += c[b] > 0;
    int incl = local;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[wid] = incl;
    __syncthreads();
    if (wid == 0) {  // inclusive scan of the 32 warp totals
      int t = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < SCAN_WARPS; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += y;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    int rank = base + (wid ? warp_sum[wid - 1] : 0) + incl - local;
#pragma unroll
    for (int b = 0; b < ITEMS; ++b) {
      if (c[b] > 0) {
        uk[rank] = beg + b;
        uc[rank] = c[b];
        ++rank;
      }
    }
    base += warp_sum[SCAN_WARPS - 1];
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts: int32 scratch of at least max(V, 1) entries; mask may be null
// (a scalar key column, S = 1).  uk, uc: int32 [R * S].
extern "C" int gk_joinkeys_launch(const uint8_t* valid, const int* kind,
                                  const uint8_t* ns_empty, int kind_id,
                                  int namespaced, const int* sid,
                                  const uint8_t* mask, int R, int S, int V,
                                  int* counts, int* uk, int* uc,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V > 0) {
    const cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)V * sizeof(int), s);
    if (e != cudaSuccess) return e;
  }
  if (R > 0 && S > 0) {
    const unsigned blocks = (unsigned)((R + ROW_THREADS - 1) / ROW_THREADS);
    count_kernel<<<blocks, ROW_THREADS, 0, s>>>(valid, kind, ns_empty, kind_id,
                                                namespaced, sid, mask, R, S, V,
                                                counts, uk, uc);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (V > 0 && R > 0 && S > 0) {
    compact_kernel<<<1, SCAN_THREADS, 0, s>>>(counts, V, uk, uc);
  }
  return cudaGetLastError();
}

// in_uk, in_uc: int32 [N], the shards' tables one after another; counts:
// int32 scratch of at least max(V, 1) entries; uk, uc: int32 [N], the
// merged table.
extern "C" int gk_joinkeys_merge_launch(const int* in_uk, const int* in_uc,
                                        int N, int V, int* counts, int* uk,
                                        int* uc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V > 0) {
    const cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)V * sizeof(int), s);
    if (e != cudaSuccess) return e;
  }
  if (N > 0) {
    const unsigned blocks = (unsigned)((N + ROW_THREADS - 1) / ROW_THREADS);
    merge_count_kernel<<<blocks, ROW_THREADS, 0, s>>>(in_uk, in_uc, N, V,
                                                      counts, uk, uc);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (V > 0 && N > 0) {
    compact_kernel<<<1, SCAN_THREADS, 0, s>>>(counts, V, uk, uc);
  }
  return cudaGetLastError();
}
