// K8: the join lookup, int32 [R * S] counts at query key ids.
//
//   out[t] = uc[i]  where uk[i] == q[t] and q[t] >= 0, else 0
//            minus 1 where row t / S itself takes part in the aggregate
//            (only when a scope is given: JoinCmp.exclude_self)
//
// uk is ascending: the key table K7 builds in a full sweep ([N], its tail
// KEY_INVALID with count 0), or the host join index's power-of-two table in
// a delta sweep (at least 8 entries, the same tail).  q holds interned key
// ids, -1 for a missing key and UNKNOWN_KEY (-5) for a value with no
// faithful key; both negative, both count 0.  A row takes part when valid,
// of kind kind_id and in the scope (1 namespaced: ns_empty false, 0
// cluster: ns_empty true); scope -1 subtracts nothing.
//
// Two modes, two launchers.  Table mode searches (uk, uc).  Dense mode
// reads K7's dense counts instead, dense[k] = uc[i] where uk[i] == k, for
// the ids below V = dense's length: out = 0 <= q < V ? dense[q] : 0.  Key
// ids are interned below V, so both modes give the same count on every
// query; a full sweep (one card or the mesh's merged table) has the dense
// counts, a delta sweep's host tables have none.
//
// Replaces gatekeeper_tpu/ops/joinkernel.py lookup_counts (a searchsorted
// and a gather) and the self-exclusion of gatekeeper_tpu/ops/vexpr.py
// _eval_joincmp.  The comparison with the right-hand side stays in plain
// torch (ops/vexpr.py _cmp_values).
//
// What bounds it: bytes.  Each query reads 4 bytes and writes 4, each row's
// three review fields 6 bytes; table mode reads what its searches touch
// (one binary search's keys and the count it finds, 4 bytes each, the
// whole table at most), dense mode one count a query (the dense counts at
// most): at R = 131072 and S = 2, about 5.0 MB with a 262144-entry table
// (1.5 us at 3.35 TB/s) and 3.7 MB with V = 203,706 (1.1 us).  A delta
// sweep's table-mode lookups are a few dozen queries into tables of up to
// 65,536 entries: about 4 KB, nothing beside a launch's floor; what sets
// their pace is the launches and, inside one, the chain of dependent loads
// of a search, L2 hits each.
//
// Design.  Table mode (gk_joinlookup_table_launch): every table-mode
// lookup of one evaluation in ONE launch, from a table of descriptors (one
// a lookup: its tables, queries, rows, scope, output and blocks; the
// blocks of lookup l follow those of the lookups before it, a prefix sum
// the host takes, so a lookup of R x S = 0 takes none).  The table is the
// kernel's parameter (__grid_constant__, up to MAX_LOOKUPS lookups, 8 KB
// of the 32 KB a launch's parameters may take since CUDA 12.1), so a
// launch copies nothing to the card first: a table uploaded through a
// pinned buffer cost the one-lookup launch 0.001 ms (PERF.md, K8's table
// mode).  A warp searches
// one query: a 32-ary lower bound, each step's 32 lanes loading 32 evenly
// spaced pivots of the interval at once and __ballot_sync / __ffs picking
// the sub-interval, so T = 65,536 takes 4 dependent loads where a binary
// search takes 16, and a table of at most 32 entries one.  The lower bound
// makes the KEY_INVALID tail and a table without one behave alike: a query
// past every key lands at T and finds nothing.  The query is the warp's,
// so the warp stays converged around each ballot.  Dense mode
// (gk_joinlookup_launch): one thread per row of a slot column of S = 2
// whose q and out are 8-byte aligned (the full sweep's ingress hosts): one
// int2 load of the row's two ids, its review fields read once for both,
// one int2 store; otherwise one thread per query.  At the full sweep's
// shape the row threads time 3% below the query threads in turns
// (PERF.md, K8's dense mode).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;

// 1 where row r takes part in the plan's aggregate under scope (>= 0)
__device__ __forceinline__ int self_part(const uint8_t* valid,
                                         const int* kind,
                                         const uint8_t* ns_empty, int kind_id,
                                         int scope, long long r) {
  return valid[r] && kind[r] == kind_id &&
         ((ns_empty[r] != 0) == (scope == 0));
}

// the table launch's descriptor of a lookup, DW int64 words
// (ops/joinlookup.py table_launch): uk, uc, T, q, R, S, valid, kind,
// ns_empty, kind_id, scope, out, its first block, its blocks; and the
// lookups a launch takes at most (ops/joinlookup.py MAX_LOOKUPS)
constexpr int DW = 16;
constexpr int MAX_LOOKUPS = 64;

struct Lookups {
  long long d[MAX_LOOKUPS * DW];
};
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// The lower bound of key in the ascending uk[0, T): the first i with
// uk[i] >= key, T where there is none.  Every lane of the warp calls it
// with the same key.  [lo, hi) is the part still unknown, the answer in
// [lo, hi] (hi is T or an entry known >= key); a step of n > 32 entries
// tests the pivots lo + (l + 1) * ceil(n / 32) - 1 of lanes l (the last
// one hi - 1), and keeps the run between the last pivot below key and the
// first one not below; a step of n <= 32 tests every entry.
__device__ __forceinline__ int lower_bound_warp(const int* __restrict__ uk,
                                                int T, int key, int lane) {
  int lo = 0, hi = T;
  while (true) {
    const int n = hi - lo;
    if (n <= 32) {
      const unsigned b =
          __ballot_sync(FULL, lane < n && __ldg(uk + lo + lane) >= key);
      return b ? lo + __ffs(b) - 1 : hi;
    }
    const int step = (n + 31) / 32;
    const int p = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned b = __ballot_sync(FULL, __ldg(uk + p) >= key);
    if (b == 0) return hi;
    const int f = __ffs(b) - 1;
    hi = min(lo + (f + 1) * step - 1, hi - 1);
    lo += f * step;
  }
}

__global__ void table_kernel(const __grid_constant__ Lookups lookups,
                             int L) {
  const long long* desc = lookups.d;
  // the block's lookup: the last whose first block is not after this one
  int l = 0, top = L - 1;
  while (l < top) {
    const int mid = (l + top + 1) >> 1;
    if (desc[(long long)mid * DW + 12] <= (long long)blockIdx.x) l = mid;
    else top = mid - 1;
  }
  const long long* d = desc + (long long)l * DW;
  const int* uk = reinterpret_cast<const int*>(d[0]);
  const int* uc = reinterpret_cast<const int*>(d[1]);
  const int T = (int)d[2];
  const int* q = reinterpret_cast<const int*>(d[3]);
  const int S = (int)d[5];
  const long long n = d[4] * S;
  const int scope = (int)d[10];
  int* out = reinterpret_cast<int*>(d[11]);
  const int lane = threadIdx.x & 31;
  const long long stride = d[13] * WARPS;
  for (long long t = ((long long)blockIdx.x - d[12]) * WARPS +
                     threadIdx.x / 32;
       t < n; t += stride) {
    const int key = q[t];
    int c = 0;
    if (key >= 0) {
      const int i = lower_bound_warp(uk, T, key, lane);
      if (i < T && uk[i] == key) c = uc[i];
    }
    if (lane == 0) {
      if (scope >= 0)
        c -= self_part(reinterpret_cast<const uint8_t*>(d[6]),
                       reinterpret_cast<const int*>(d[7]),
                       reinterpret_cast<const uint8_t*>(d[8]), (int)d[9],
                       scope, t / S);
      out[t] = c;
    }
  }
}

__device__ __forceinline__ int dense_count(const int* __restrict__ dense,
                                           int V, int key) {
  // a negative id is above every V as unsigned
  return (unsigned)key < (unsigned)V ? __ldg(dense + key) : 0;
}

template <bool PAIR>
__global__ void dense_kernel(const int* __restrict__ dense, int V,
                             const int* __restrict__ q, int R, int S,
                             const uint8_t* __restrict__ valid,
                             const int* __restrict__ kind,
                             const uint8_t* __restrict__ ns_empty,
                             int kind_id, int scope, int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (PAIR) {  // t is a row of two slots
    if (t >= R) return;
    const int self =
        scope >= 0 ? self_part(valid, kind, ns_empty, kind_id, scope, t) : 0;
    const int2 k = reinterpret_cast<const int2*>(q)[t];
    reinterpret_cast<int2*>(out)[t] = make_int2(
        dense_count(dense, V, k.x) - self, dense_count(dense, V, k.y) - self);
  } else {  // t is a query
    if (t >= (long long)R * S) return;
    int c = dense_count(dense, V, q[t]);
    if (scope >= 0)
      c -= self_part(valid, kind, ns_empty, kind_id, scope, t / S);
    out[t] = c;
  }
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Table mode: L <= MAX_LOOKUPS descriptors in host memory (DW words each,
// blocks of lookup l from desc[l * DW + 12], desc[l * DW + 13] of them),
// copied into the launch's parameters; blocks in all, > 0.
extern "C" int gk_joinlookup_table_launch(const long long* desc, int L,
                                          int blocks, void* stream) {
  if (L <= 0 || L > MAX_LOOKUPS || blocks <= 0) return cudaErrorInvalidValue;
  Lookups lookups;
  memcpy(lookups.d, desc, sizeof(long long) * DW * L);
  table_kernel<<<(unsigned)blocks, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(lookups, L);
  return cudaGetLastError();
}

// Dense mode: dense [V] read, V > 0.  valid, kind, ns_empty may be null
// when scope is -1.  R * S > 0.
extern "C" int gk_joinlookup_launch(const int* dense, int V, const int* q,
                                    int R, int S, const uint8_t* valid,
                                    const int* kind, const uint8_t* ns_empty,
                                    int kind_id, int scope, int* out,
                                    void* stream) {
  if (dense == nullptr || V <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)R * S;
  const bool pair = S == 2 && ((uintptr_t)q & 7) == 0 &&
                    ((uintptr_t)out & 7) == 0;
  if (pair)
    dense_kernel<true><<<blocks_for(R), THREADS, 0, s>>>(
        dense, V, q, R, S, valid, kind, ns_empty, kind_id, scope, out);
  else
    dense_kernel<false><<<blocks_for(total), THREADS, 0, s>>>(
        dense, V, q, R, S, valid, kind, ns_empty, kind_id, scope, out);
  return cudaGetLastError();
}
