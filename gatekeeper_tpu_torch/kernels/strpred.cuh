// The string-predicate hit of one element, shared by K2 (strpred.cu) and
// K9 (program.cu), so the standalone checks of K2 check what K9 runs.
//
//   negate ^ (tcode == STRING && sid >= 0 &&
//             tableT[clip(sid, 0, V-1), col] != 0)
//
// tableT is a group's predicate tables transposed to [V, U]; col is the
// constraint's (or its parameter element's) column of them.
#pragma once
#include <stdint.h>

namespace gk {

constexpr int T_STR = 5;

__device__ __forceinline__ bool strpred_cell(const uint8_t* tableT, int V,
                                             int U, int col, int tcode,
                                             int sid, bool negate) {
  const bool hit = tcode == T_STR && sid >= 0 &&
                   tableT[(size_t)min(max(sid, 0), V - 1) * U + col] != 0;
  return hit != negate;
}

}  // namespace gk
