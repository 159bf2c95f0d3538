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
// Two modes, one function.  Table mode (0) searches (uk, uc).  Dense mode
// (1) reads K7's dense counts instead, dense[k] = uc[i] where uk[i] == k,
// for the ids below V = dense's length: out = 0 <= q < V ? dense[q] : 0.
// Key ids are interned below V, so both modes give the same count on every
// query; a full sweep (one card or the mesh's merged table) has the dense
// counts, a delta sweep's host table has none.
//
// Replaces gatekeeper_tpu/ops/joinkernel.py lookup_counts (a searchsorted
// and a gather) and the self-exclusion of gatekeeper_tpu/ops/vexpr.py
// _eval_joincmp.  The comparison with the right-hand side stays in plain
// torch (ops/vexpr.py _cmp_values).
//
// What bounds it: bytes.  Each query reads 4 bytes and writes 4, each row's
// three review fields 6 bytes; table mode reads the table once (8 bytes an
// entry), dense mode the dense counts (4 bytes an id): at R = 131072 and
// S = 2, about 5.0 MB with a 262144-entry table (1.5 us at 3.35 TB/s) and
// 3.7 MB with V = 203,706 (1.1 us).  In table mode the log2(T) dependent
// loads of each binary search, mostly L2 hits on a table of at most 2 MB,
// set the pace in practice; dense mode makes that one load, from an array
// of 4 V bytes (815 KB at V = 203,706) that stays in the 50 MB L2.
//
// Design.  Table mode: one thread per query, a lower-bound binary search
// over [0, T), so the KEY_INVALID tail and a table with no tail behave
// alike: a query past every key lands at T and finds nothing.  Dense mode:
// one thread per row of a slot column of S = 2 whose q and out are 8-byte
// aligned (the full sweep's ingress hosts): one int2 load of the row's two
// ids, its review fields read once for both, one int2 store; otherwise one
// thread per query.  At the full sweep's shape the row threads time 3%
// below the query threads in turns (PERF.md, K8's dense mode).
#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void lookup_kernel(const int* __restrict__ uk,
                              const int* __restrict__ uc, int T,
                              const int* __restrict__ q, int R, int S,
                              const uint8_t* __restrict__ valid,
                              const int* __restrict__ kind,
                              const uint8_t* __restrict__ ns_empty,
                              int kind_id, int scope, int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)R * S) return;
  const int key = q[t];
  int c = 0;
  if (key >= 0) {
    int lo = 0, hi = T;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (uk[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    if (lo < T && uk[lo] == key) c = uc[lo];
  }
  if (scope >= 0)
    c -= self_part(valid, kind, ns_empty, kind_id, scope, t / S);
  out[t] = c;
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

// mode 0 (table): uk, uc [T] searched, dense unused (may be null).  mode 1
// (dense): dense [V] read, V > 0, uk, uc unused.  valid, kind, ns_empty may
// be null when scope is -1.  R * S > 0.
extern "C" int gk_joinlookup_launch(const int* uk, const int* uc, int T,
                                    const int* dense, int V, int mode,
                                    const int* q, int R, int S,
                                    const uint8_t* valid, const int* kind,
                                    const uint8_t* ns_empty, int kind_id,
                                    int scope, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)R * S;
  if (mode == 0) {
    lookup_kernel<<<blocks_for(total), THREADS, 0, s>>>(
        uk, uc, T, q, R, S, valid, kind, ns_empty, kind_id, scope, out);
  } else if (mode == 1 && dense != nullptr && V > 0) {
    const bool pair = S == 2 && ((uintptr_t)q & 7) == 0 &&
                      ((uintptr_t)out & 7) == 0;
    if (pair)
      dense_kernel<true><<<blocks_for(R), THREADS, 0, s>>>(
          dense, V, q, R, S, valid, kind, ns_empty, kind_id, scope, out);
    else
      dense_kernel<false><<<blocks_for(total), THREADS, 0, s>>>(
          dense, V, q, R, S, valid, kind, ns_empty, kind_id, scope, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
