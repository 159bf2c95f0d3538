// The set count of one (constraint, review) cell, shared by K3
// (setcount.cu) and K9 (program.cu), so the standalone checks of K3 check
// what K9 runs.
//
//   orient 0:  cnt = sum_p cm[p] && !exists_k(kr[k] == ci[p] && kr[k] != pad)
//   orient 1:  cnt = sum_k kr[k] != pad && !exists_p(ci[p] == kr[k] && cm[p])
//
// ci / cm are the constraint's P parameter ids and their mask (in shared
// memory in K3, in device memory in K9), kr the review's K key ids.
#pragma once
#include <stdint.h>

namespace gk {

// op codes: 0 >, 1 >=, 2 <, 3 <=, 4 ==, 5 !=
__device__ __forceinline__ bool setcount_compare(int cnt, int op, int n) {
  switch (op) {
    case 0: return cnt > n;
    case 1: return cnt >= n;
    case 2: return cnt < n;
    case 3: return cnt <= n;
    case 4: return cnt == n;
    default: return cnt != n;
  }
}

template <typename M>
__device__ __forceinline__ int setcount_count(const int* ci, const M* cm,
                                              int P, const int* kr, int K,
                                              int pad, int orient) {
  int cnt = 0;
  if (orient == 0) {
    for (int p = 0; p < P; ++p) {
      if (!cm[p]) continue;
      bool in = false;
      for (int k = 0; k < K && !in; ++k) in = kr[k] == ci[p] && kr[k] != pad;
      cnt += !in;
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const int x = kr[k];
      if (x == pad) continue;
      bool in = false;
      for (int p = 0; p < P && !in; ++p) in = cm[p] && ci[p] == x;
      cnt += !in;
    }
  }
  return cnt;
}

}  // namespace gk
