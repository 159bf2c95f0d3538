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
// Replaces gatekeeper_tpu/ops/joinkernel.py lookup_counts (a searchsorted
// and a gather) and the self-exclusion of gatekeeper_tpu/ops/vexpr.py
// _eval_joincmp.  The comparison with the right-hand side stays in plain
// torch (ops/vexpr.py _cmp_values).
//
// What bounds it: bytes.  Each query reads 4 bytes and writes 4, each row's
// three review fields 6 bytes, and the table is read once (8 bytes an
// entry): about 3.5 MB at R = 131072, S = 2 and a 262144-entry table,
// about 1 us at 3.35 TB/s.  The log2(T) compares of each binary search are
// few beside it; its dependent loads, mostly L2 hits on a table of at most
// 2 MB, set the pace in practice.
//
// Design: one thread per query, a lower-bound binary search over [0, T),
// so the KEY_INVALID tail and a table with no tail behave alike: a query
// past every key lands at T and finds nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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
  if (scope >= 0) {
    const int r = (int)(t / S);
    c -= valid[r] && kind[r] == kind_id &&
         ((ns_empty[r] != 0) == (scope == 0));
  }
  out[t] = c;
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// valid, kind, ns_empty may be null when scope is -1.
extern "C" int gk_joinlookup_launch(const int* uk, const int* uc, int T,
                                    const int* q, int R, int S,
                                    const uint8_t* valid, const int* kind,
                                    const uint8_t* ns_empty, int kind_id,
                                    int scope, int* out, void* stream) {
  const long long total = (long long)R * S;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  lookup_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      uk, uc, T, q, R, S, valid, kind, ns_empty, kind_id, scope, out);
  return cudaGetLastError();
}
