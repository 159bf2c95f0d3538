// K7: the provider key table of one join plan, (uk, uc) int32, each [N],
// and the dense counts it is compacted from, int32 [max(V, 1)].
//
//   uk[0..u)  = the distinct keys of the participating rows, ascending
//   uc[0..u)  = for each, the number of distinct rows that provide it
//   uk[u..N)  = KEY_INVALID (2^31 - 1), uc[u..N) = 0
//   counts[k] = uc[i] where uk[i] == k, else 0 (k < V)
//
// A row participates when valid, of the plan's remote kind and in its
// scope (namespaced: ns_empty false; cluster: ns_empty true).  Its keys are
// sid[r, 0..S) where mask (if any) is set and the id is >= 0; a key the row
// holds twice counts once.  N = R * S (S = 1 for a scalar key column).
//
// Replaces gatekeeper_tpu/ops/joinkernel.py provider_key_table on one device
// (with row_distinct_slot_keys and compact_key_table, weight 1), which on
// the TPU sorted the row-sorted keys and segment-reduced the runs.  The
// output is bit-equal to it.  The dense counts are what K8 reads in a full
// sweep (kernels/joinlookup.cu, dense mode).
//
// What bounds it: bytes.  It reads each row's three review fields (6 bytes)
// and S key ids and mask bytes (5 bytes each), and writes 8 bytes for each
// of the N table entries and 4 for each of the V dense counts: about 5.0 MB
// at R = 131072, S = 2, V = 203,706, about 1.5 us at 3.35 TB/s.  Its four
// phases and three grid-wide barriers, each a few microseconds, set its
// time in practice.
//
// Design: key ids are interned ids in [0, V), V the interner's size when
// the sweep was packed, passed from the host.  So no sort, and one
// cooperative launch (every block resident at once, so blocks may wait for
// each other) of a grid sized to fill every SM, in four phases separated
// by grid syncs: (1) zero counts [V]; (2) one thread per row tests
// participation, drops the keys it already counted among its own earlier
// slots and atomicAdds 1 per distinct key into counts (integer atomics:
// the result does not depend on their order); (3) block b takes the b-th
// contiguous chunk of the V ids and counts its nonzero entries; (4) each
// block sums the chunk totals before its own (its first rank) and of all
// (u), walks its chunk again in passes of one id a thread, ranks each
// nonzero count inside the pass with a warp ballot, __popc and a scan of
// the warp counts, writes (id, count) at that rank, and every block fills
// its share of the tail [u, N).  Ranks ascend with the ids because chunks
// and passes do.  Ids outside [0, V) are not counted: the wrapper's caller
// guarantees there are none.
//
// The merge (gk_joinkeys_merge_launch).  On a mesh each shard builds its
// slab's table with the launcher above; the tables of every shard,
// concatenated on one device ([N] = W tables), merge into the table of the
// whole row axis.  This replaces the all_gather and second
// compact_key_table(keys, counts) of gatekeeper_tpu/ops/joinkernel.py
// provider_key_table (:262-267), bit-equal to it for shard tables (a valid
// key's count is at least 1).  Bound: bytes, the [N] tables read and the
// [N] merged table written, 16 N bytes, and the [V] counts, 4 V.  Design: the
// same launch, whose phase (2) takes a thread per entry adding its count
// (not 1) with an integer atomic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KEY_INVALID = 2147483647;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// blocks a SM at most: enough threads for a row each at R = 131072 on 132
// SMs, few blocks at each grid barrier
constexpr int BLOCKS_PER_SM = 2;
constexpr int MAX_DEVICES = 64;

struct Args {
  // the rows (K7)
  const uint8_t* valid;
  const int* kind;
  const uint8_t* ns_empty;
  int kind_id, namespaced;
  const int* sid;
  const uint8_t* mask;
  int R, S;
  // the shards' tables (the merge)
  const int* in_uk;
  const int* in_uc;
  // the output table's length, the vocabulary
  int N, V;
  int* counts;  // [max(V, 1)], returned
  int* totals;  // [gridDim.x], scratch
  int* uk;
  int* uc;
};

// The sum of v over the block, in every thread.  red: WARPS ints of shared
// memory, free to reuse once every thread has returned.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();  // red may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return __reduce_add_sync(0xffffffffu, lane < WARPS ? red[lane] : 0);
}

template <bool MERGE>
__global__ void __launch_bounds__(THREADS) table_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int red[WARPS];
  __shared__ int warp_n[WARPS];
  const long long G = gridDim.x;
  const long long tid = blockIdx.x * (long long)THREADS + threadIdx.x;
  const long long stride = G * THREADS;
  const int V = a.V;

  // (1) zero the dense counts
  for (long long i = tid; i < (V > 0 ? V : 1); i += stride) a.counts[i] = 0;
  grid.sync();

  // (2) count
  if (MERGE) {
    for (long long i = tid; i < a.N; i += stride) {
      const int k = a.in_uk[i];
      const int w = a.in_uc[i];
      if (k >= 0 && k < V && w != 0) atomicAdd(a.counts + k, w);
    }
  } else {
    for (long long r = tid; r < a.R; r += stride) {
      if (!(a.valid[r] && a.kind[r] == a.kind_id &&
            ((a.ns_empty[r] != 0) != (a.namespaced != 0))))
        continue;
      const int* row = a.sid + r * a.S;
      const uint8_t* m = a.mask ? a.mask + r * a.S : nullptr;
      for (int j = 0; j < a.S; ++j) {
        const int k = row[j];
        if (k < 0 || k >= V || (m && !m[j])) continue;
        bool seen = false;
        for (int i = 0; i < j && !seen; ++i) seen = row[i] == k && (!m || m[i]);
        if (!seen) atomicAdd(a.counts + k, 1);
      }
    }
  }
  grid.sync();

  // (3) this block's chunk [lo, hi) of the ids: its nonzero counts
  const long long chunk = (V + G - 1) / G;
  const long long lo = min((long long)V, blockIdx.x * chunk);
  const long long hi = min((long long)V, lo + chunk);
  int nz = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS)
    nz += a.counts[i] > 0;
  nz = block_sum(nz, red);
  if (threadIdx.x == 0) a.totals[blockIdx.x] = nz;
  grid.sync();

  // (4) the chunk's first rank and the table's length u
  int before = 0, all = 0;
  for (int b = threadIdx.x; b < G; b += THREADS) {
    const int t = a.totals[b];
    all += t;
    before += b < (int)blockIdx.x ? t : 0;
  }
  int base = block_sum(before, red);
  const long long u = block_sum(all, red);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  // the passes' bounds are the block's, so every thread takes each ballot
  for (long long s = lo; s < hi; s += THREADS) {
    const long long i = s + threadIdx.x;
    const int c = i < hi ? a.counts[i] : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, c > 0);
    if (lane == 0) warp_n[wid] = __popc(bal);
    __syncthreads();
    int off = 0, pass = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int n = warp_n[w];
      off += w < wid ? n : 0;
      pass += n;
    }
    if (c > 0) {
      const int rank = base + off + __popc(bal & ((1u << lane) - 1u));
      a.uk[rank] = (int)i;
      a.uc[rank] = c;
    }
    base += pass;
    __syncthreads();  // warp_n is rewritten by the next pass
  }
  for (long long i = u + tid; i < a.N; i += stride) {
    a.uk[i] = KEY_INVALID;
    a.uc[i] = 0;
  }
}

// The grid of a launch of table_kernel<MERGE> on the current device: as
// many blocks as fit at once on every SM, at most BLOCKS_PER_SM a SM and
// at most slots; -> the grid (> 0) or minus a cudaError_t.
template <bool MERGE>
int grid_size(int slots) {
  static int cached[MAX_DEVICES];  // 0: not yet known
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  int grid = dev < MAX_DEVICES ? cached[dev] : 0;
  if (grid == 0) {
    int sms = 0, coop = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, table_kernel<MERGE>, THREADS, 0);
    if (e != cudaSuccess) return -(int)e;
    if (!coop || occ < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
    grid = (occ < BLOCKS_PER_SM ? occ : BLOCKS_PER_SM) * sms;
    if (dev < MAX_DEVICES) cached[dev] = grid;
  }
  if (slots < 1) return -(int)cudaErrorInvalidValue;
  return grid < slots ? grid : slots;
}

template <bool MERGE>
int launch(Args a, int slots, void* stream) {
  const int grid = grid_size<MERGE>(slots);
  if (grid < 0) return -grid;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)table_kernel<MERGE>, dim3(grid), dim3(THREADS), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The grid both launchers use on the current device with ``slots`` total
// slots (merge 0: K7's table, 1: the merge); minus a cudaError_t on error.
extern "C" int gk_joinkeys_grid(int merge, int slots) {
  return merge ? grid_size<true>(slots) : grid_size<false>(slots);
}

// The block size of both launchers: each block walks its chunk of ids in
// passes of this many.
extern "C" int gk_joinkeys_threads() { return THREADS; }

// counts: int32 [max(V, 1)], the dense counts out; totals: int32 [slots]
// scratch (the grid is at most slots blocks); mask may be null (a scalar
// key column, S = 1).  uk, uc: int32 [R * S], R * S > 0.
extern "C" int gk_joinkeys_launch(const uint8_t* valid, const int* kind,
                                  const uint8_t* ns_empty, int kind_id,
                                  int namespaced, const int* sid,
                                  const uint8_t* mask, int R, int S, int V,
                                  int* counts, int* totals, int slots,
                                  int* uk, int* uc, void* stream) {
  Args a{valid, kind, ns_empty, kind_id, namespaced, sid, mask, R, S,
         nullptr, nullptr, R * S, V, counts, totals, uk, uc};
  return launch<false>(a, slots, stream);
}

// in_uk, in_uc: int32 [N], the shards' tables one after another, N > 0;
// counts, totals, slots as above; uk, uc: int32 [N], the merged table.
extern "C" int gk_joinkeys_merge_launch(const int* in_uk, const int* in_uc,
                                        int N, int V, int* counts,
                                        int* totals, int slots, int* uk,
                                        int* uc, void* stream) {
  Args a{nullptr, nullptr, nullptr, 0, 0, nullptr, nullptr, 0, 0,
         in_uk, in_uc, N, V, counts, totals, uk, uc};
  return launch<true>(a, slots, stream);
}
