// K1: the constraint x review match and autoreject masks, bool[C, R] each.
//
// Replaces gatekeeper_tpu/ops/matchkernel.py:115 match_kernel (with
// _selector_match and _any_labelselector_match), which XLA fused from a
// Python unroll over the small static widths.
//
// What bounds it on an H100: writing the two [C, R] byte masks (2*C*R
// bytes; about 268 MB at C=1024, R=131072, about 80 us at 3.35 TB/s).  The
// per-cell work is a few integer compares for each live entry of the
// constraint's lists, and a walk of the review's label slots for each live
// selector entry.  A kernel that walks every padded slot of every list for
// every cell, and reloads each review's fields for a few constraints,
// spends its time issuing instructions instead (about 100 a cell, 7x the
// byte bound, in the kernel this one replaced).
//
// Design: constraint_records (ops/matchkernel.py) packs each constraint
// into one int32 record with the number of live entries of every padded
// list (one past the last live one), so a cell loops over live entries
// only, and a selector with none is skipped whole (a branch on the record,
// the same for every thread on that constraint): every PAD entry of a
// list is a no-op of its loop, since a label's value is an interned id or
// NON_STRING, never PAD.  A thread owns V consecutive reviews: it loads
// their row fields once (V bytes or V ints an access where aligned) into
// registers and walks the block's constraints, staged in shared memory,
// CT of them (up to CT_MAX, fewer where the records are wide), so each
// review's fields are read C / CT times in all.  Each constraint's scalar
// fields are read once for the V reviews, and both masks are stored V
// bytes at a time.  When R is small (a review is 8 rows) the threads of a
// block split the constraints instead of the rows, so none idles while
// another walks them all.  Label slots are walked per cell where a
// selector is live, from L1: where a warp holds 32 V consecutive reviews
// on one constraint it shuffles the walks so that lane t walks reviews
// 32 i + t, each label access reading 32 consecutive reviews, and shuffles
// the failures back.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int PAD = -2;
constexpr int WILD = -1;
constexpr int UNDEF = -4;
constexpr int SCOPE_NONE = 0;
constexpr int V = 8;             // reviews a thread
constexpr int CT_MAX = 64;       // constraints a block
constexpr int THREADS = 128;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on Hopper
constexpr unsigned FULL = 0xffffffffu;

struct Sel {
  int ml, Lc, op, key, vals, nvals, E, V;
};

// Offsets (in ints) of each field inside one constraint record, and the
// padded widths.  The order is the wrapper's
// (gatekeeper_tpu_torch/ops/matchkernel.py).  ``live`` holds nine live
// lengths: kind pairs, namespace ids, excluded ids, then for each selector
// its matchLabels pairs, expressions and expression values.
struct Layout {
  int W;
  int kp, KP;
  int ns, N;
  int ex, X;
  int has_ns, has_ex, scope, has_nssel, valid;
  Sel ls, nssel;
  int live;
};
static_assert(sizeof(Layout) == 29 * sizeof(int), "layout is 29 ints");
enum Live { L_KP = 0, L_NS, L_EX, L_LS, L_NSSEL = 6 };

__device__ bool key_val_hit(const int* lab, int L, int k, int v) {
  for (int l = 0; l < L; ++l) {
    const int lk = lab[2 * l];
    if (lk == k && lab[2 * l + 1] == v && lk != PAD) return true;
  }
  return false;
}

__device__ bool key_hit(const int* lab, int L, int k) {
  for (int l = 0; l < L; ++l) {
    const int lk = lab[2 * l];
    if (lk == k && lk != PAD) return true;
  }
  return false;
}

// matches_label_selector: every live matchLabels pair, then every live
// expression; n: the selector's three live lengths.
__device__ bool selector_match(const int* lab, int L, const int* rec,
                               const Sel& s, const int* n) {
  for (int i = 0; i < n[0]; ++i) {
    const int k = rec[s.ml + 2 * i];
    const int v = rec[s.ml + 2 * i + 1];
    if (k != PAD && !key_val_hit(lab, L, k, v)) return false;
  }
  for (int e = 0; e < n[1]; ++e) {
    const int op = rec[s.op + e];
    if (op == -1) continue;
    const int key = rec[s.key + e];
    const bool has = key_hit(lab, L, key);
    bool val_in = false;
    for (int v = 0; v < n[2] && !val_in; ++v)
      val_in = key_val_hit(lab, L, key, rec[s.vals + e * s.V + v]);
    const bool nv = rec[s.nvals + e] > 0;
    bool violated;
    if (op == 0) violated = !has || (nv && !val_in);  // In
    else if (op == 1) violated = has && nv && val_in;  // NotIn
    else if (op == 2) violated = !has;                 // Exists
    else if (op == 3) violated = has;                  // DoesNotExist
    else violated = false;
    if (violated) return false;
  }
  return true;
}

__device__ bool any_labelselector(const int* obj, int L1, const int* old,
                                  int L2, bool obj_e, bool old_e,
                                  const int* rec, const Sel& s,
                                  const int* n) {
  if (obj_e && old_e) return selector_match(obj, 0, rec, s, n);
  if (old_e) return selector_match(obj, L1, rec, s, n);
  if (obj_e) return selector_match(old, L2, rec, s, n);
  return selector_match(obj, L1, rec, s, n) ||
         selector_match(old, L2, rec, s, n);
}

__device__ __forceinline__ bool whole(const void* p, int n, int align) {
  return n >= V && (reinterpret_cast<uintptr_t>(p) & (align - 1)) == 0;
}

// V bytes of a row field as bits (lanes at or past n: 0)
__device__ __forceinline__ unsigned load_flags(const uint8_t* p, int n) {
  unsigned bits = 0;
  if (whole(p, n, 8)) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bits |= (unsigned)(((u.x >> (8 * i)) & 0xffu) != 0) << i;
      bits |= (unsigned)(((u.y >> (8 * i)) & 0xffu) != 0) << (4 + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < n && p[i]) bits |= 1u << i;
  }
  return bits;
}

__device__ __forceinline__ void load_ints(const int* p, int n, int out[V]) {
  if (whole(p, n, 16)) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const int4 u = reinterpret_cast<const int4*>(p)[q];
      out[4 * q] = u.x;
      out[4 * q + 1] = u.y;
      out[4 * q + 2] = u.z;
      out[4 * q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = i < n ? p[i] : UNDEF;
  }
}

// bit i -> byte i (0 or 1), V bytes at p.  x * 0x00204081 puts bit j of
// a 4-bit x at bit 8j, and nothing else in those bits.
__device__ __forceinline__ void store_bits(uint8_t* p, int n, unsigned bits) {
  if (whole(p, n, 8)) {
    const uint2 u{((bits & 15u) * 0x00204081u) & 0x01010101u,
                  (((bits >> 4) & 15u) * 0x00204081u) & 0x01010101u};
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < n) p[i] = (bits >> i) & 1u;
  }
}

__device__ __forceinline__ bool on(unsigned bits, int i) {
  return (bits >> i) & 1u;
}

// bit i: a[i] == x
__device__ __forceinline__ unsigned eq_bits(const int a[V], int x) {
  unsigned b = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) b |= (unsigned)(a[i] == x) << i;
  return b;
}

// bit i: ns[i] is one of the n ids (PAD entries never are)
__device__ __forceinline__ unsigned member_bits(const int ns[V],
                                                const int* ids, int n) {
  unsigned b = 0;
  for (int q = 0; q < n; ++q)
    if (ids[q] != PAD) b |= eq_bits(ns, ids[q]);
  return b;
}

__global__ void __launch_bounds__(THREADS)
    match_kernel(Layout lo, const int* __restrict__ crec, int C, int R,
                 int CT, int TX, const int* __restrict__ group,
                 const int* __restrict__ kind,
                 const int* __restrict__ ns_name,
                 const int8_t* __restrict__ ns_mode,
                 const uint8_t* __restrict__ always,
                 const uint8_t* __restrict__ ns_empty,
                 const uint8_t* __restrict__ obj_empty,
                 const uint8_t* __restrict__ old_empty,
                 const uint8_t* __restrict__ rv_autoreject,
                 const uint8_t* __restrict__ rv_valid,
                 const int* __restrict__ obj_labels,
                 const int* __restrict__ old_labels,
                 const int* __restrict__ ns_labels, int L1, int L2, int L3,
                 uint8_t* __restrict__ match,
                 uint8_t* __restrict__ autoreject) {
  extern __shared__ int srec[];
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  const int* src = crec + (size_t)c0 * lo.W;
  for (int i = threadIdx.x; i < nc * lo.W; i += THREADS) srec[i] = src[i];
  __syncthreads();

  // the thread's V reviews [r0, r0 + n), and its share of the constraints
  const long long r0 =
      ((long long)blockIdx.x * TX + threadIdx.x % TX) * V;
  // a thread past R stays, with no review, for its warp's shuffles
  const int n = r0 < R ? (int)min((long long)V, (long long)R - r0) : 0;
  int g[V], k[V], ns[V];
  load_ints(group + r0, n, g);
  load_ints(kind + r0, n, k);
  load_ints(ns_name + r0, n, ns);
  // the row fields as bits: bit i for review r0 + i
  const unsigned alw = load_flags(always + r0, n);
  const unsigned nse = load_flags(ns_empty + r0, n);
  const unsigned obj_e = load_flags(obj_empty + r0, n);
  const unsigned old_e = load_flags(old_empty + r0, n);
  const unsigned rej = load_flags(rv_autoreject + r0, n);
  const unsigned rvalid = load_flags(rv_valid + r0, n);
  unsigned m0 = 0, m1 = 0, m3 = 0, ns_def = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int md = i < n ? ns_mode[r0 + i] : -1;
    m0 |= (unsigned)(md == 0) << i;
    m1 |= (unsigned)(md == 1) << i;
    m3 |= (unsigned)(md == 3) << i;
    ns_def |= (unsigned)(ns[i] != UNDEF) << i;
  }
  for (int j = threadIdx.x / TX; j < nc; j += THREADS / TX) {
    // each step below ANDs one condition into the V reviews' bits, read
    // once from the record for all V
    const int* rec = srec + j * lo.W;
    const int* live = rec + lo.live;
    unsigned ok = rec[lo.valid] ? rvalid : 0u;
    const unsigned rej_bits = rec[lo.has_nssel] ? rej & ok : 0u;
    unsigned kinds = 0;  // kind selectors: any (group, kind) pair
    for (int p = 0; p < live[L_KP]; ++p) {
      const int kg = rec[lo.kp + 2 * p], kk = rec[lo.kp + 2 * p + 1];
      if (kg == PAD) continue;
      kinds |= (kg == WILD ? FULL : eq_bits(g, kg)) &
               (kk == WILD ? FULL : eq_bits(k, kk));
    }
    ok &= kinds;
    if (ok && rec[lo.has_ns])
      ok &= alw | (ns_def & member_bits(ns, rec + lo.ns, live[L_NS]));
    if (ok && rec[lo.has_ex])
      ok &= alw | (ns_def & ~member_bits(ns, rec + lo.ex, live[L_EX]));
    const int sc = rec[lo.scope];
    if (sc == 2) ok &= ~nse;
    else if (sc == 3) ok &= nse;
    else if (sc != SCOPE_NONE && sc != 1) ok = 0;
    // namespaceSelector by mode: 0 True, 1 the namespace's labels, 3 the
    // object's (both True for a selector with no live entry), else False
    const bool nssel_live = live[L_NSSEL] || live[L_NSSEL + 1];
    unsigned nssel_bits = 0;
    if (rec[lo.has_nssel]) {
      ok &= m0 | m1 | m3;
      if (nssel_live) nssel_bits = ok & (m1 | m3);
    }
    // the label walks of live selectors, one review at a time
    const bool ls_live = live[L_LS] || live[L_LS + 1];
    const unsigned walk = ok & (ls_live ? FULL : nssel_bits);
    // review r passes the live selectors: bit 0 of its obj_empty and
    // old_empty, and whether its namespaceSelector is walked, by mode
    auto pass = [&](long long r, bool oe, bool de, bool nssel, bool by_ns) {
      const int* obj = obj_labels + r * L1 * 2;
      const int* old = old_labels + r * L2 * 2;
      bool ok_r = !ls_live || any_labelselector(obj, L1, old, L2, oe, de, rec,
                                                lo.ls, live + L_LS);
      if (ok_r && nssel)
        ok_r = by_ns ? selector_match(ns_labels + r * L3 * 2, L3, rec,
                                      lo.nssel, live + L_NSSEL)
                     : any_labelselector(obj, L1, old, L2, oe, de, rec,
                                         lo.nssel, live + L_NSSEL);
      return ok_r;
    };
    if (TX >= 32) {
      // the warp holds 32 * V consecutive reviews on this constraint:
      // shuffle the walks so that lane t walks reviews base + 32 i + t,
      // and each label access reads 32 consecutive reviews, then shuffle
      // the failures back to the reviews' threads
      if (__any_sync(FULL, walk != 0)) {
        const int t = threadIdx.x & 31;
        const long long base = r0 - (long long)V * t;
        unsigned mine = 0, nss = 0;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int src = (32 * i + t) / V;
          mine |= ((__shfl_sync(FULL, walk, src) >> (t % V)) & 1u) << i;
          nss |= ((__shfl_sync(FULL, nssel_bits, src) >> (t % V)) & 1u) << i;
        }
        unsigned fail = 0;
#pragma unroll 1
        for (int i = 0; i < V; ++i) {
          if (!on(mine, i)) continue;
          const long long r = base + 32 * i + t;
          if (!pass(r, obj_empty[r] != 0, old_empty[r] != 0, on(nss, i),
                    ns_mode[r] == 1))
            fail |= 1u << i;
        }
        unsigned back = 0;
#pragma unroll
        for (int l = 0; l < V; ++l) {
          const int src = (V * t + l) % 32;
          back |= ((__shfl_sync(FULL, fail, src) >> ((V * t + l) / 32)) & 1u)
                  << l;
        }
        ok &= ~back;
      }
    } else {
      unsigned w = walk;
#pragma unroll 1
      for (int i = 0; w; ++i, w >>= 1)
        if ((w & 1u) && !pass(r0 + i, on(obj_e, i), on(old_e, i),
                              on(nssel_bits, i), on(m1, i)))
          ok &= ~(1u << i);
    }
    const size_t o = (size_t)(c0 + j) * R + r0;
    store_bits(match + o, n, ok);
    store_bits(autoreject + o, n, rej_bits);
  }
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gk_match_launch(
    const int* layout_host, const int* crec, int C, int R, const int* group,
    const int* kind, const int* ns_name, const int8_t* ns_mode,
    const uint8_t* always, const uint8_t* ns_empty, const uint8_t* obj_empty,
    const uint8_t* old_empty, const uint8_t* rv_autoreject,
    const uint8_t* rv_valid, const int* obj_labels, const int* old_labels,
    const int* ns_labels, int L1, int L2, int L3, uint8_t* match,
    uint8_t* autoreject, void* stream) {
  Layout lo;
  memcpy(&lo, layout_host, sizeof(Layout));
  if (C <= 0 || R <= 0) return 0;
  // as many constraints a block as fit, up to CT_MAX
  const long long fit = SMEM_MAX / ((long long)lo.W * (long long)sizeof(int));
  const int CT = (int)(fit < CT_MAX ? fit : CT_MAX);
  if (CT < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)CT * lo.W * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // the threads along the rows: all of a block's unless R is small, the
  // rest split the constraints
  const long long chunks = (R + V - 1) / V;
  int TX = THREADS;
  while (TX > 1 && TX / 2 >= chunks) TX /= 2;
  dim3 grid((unsigned)((chunks + TX - 1) / TX), (unsigned)((C + CT - 1) / CT));
  match_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      lo, crec, C, R, CT, TX, group, kind, ns_name, ns_mode, always,
      ns_empty, obj_empty, old_empty, rv_autoreject, rv_valid, obj_labels,
      old_labels, ns_labels, L1, L2, L3, match, autoreject);
  return cudaGetLastError();
}
