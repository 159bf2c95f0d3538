// K9: every violation-program group of one evaluation, in one launch.
//
//   mask[start_g + c, r] &= program_g(c, r)   for each group g, c < B_g
//
// A group's program is a bytecode (ops/progcode.py): a stream of
// fixed-width int32 instructions over a stack of booleans, and an operand
// table of device addresses and widths (ops/program.py packs both, with a
// header a group, into one int64 buffer per evaluation).  The cell's value
// is OR over clauses of AND over conditions; AnyParam, slot clauses and
// ReduceSlots are loops over the P or S axis of a mask operand; string
// predicates and set counts are the device functions of K2 and K3
// (strpred.cuh, setcount.cuh); a join comparison reads the counts K8
// looked up for the row before this launch.
//
// Replaces gatekeeper_tpu/ops/vexpr.py:565 eval_program (with :319
// _eval_node and :372 _cmp_values), which XLA fused into the sweep's
// executable under jax.jit (gatekeeper_tpu/ops/driver.py _eval_body).  One
// interpreter runs every program, built once with the other kernels, so a
// new template needs no compile.
//
// What bounds it: on paper, bytes: the group rows of the mask read and
// written (2 bytes a cell) and the columns each group reads once (a few
// bytes a row); the bytecode instructions a cell executes are about as
// many operations.  In practice the instructions it issues: an interpreter
// spends tens of machine instructions on each bytecode instruction a cell
// executes (decode, dispatch, the operand's kind, the row's loads and
// compare), and one that runs a cell a thread, as the kernel this one
// replaced did, adds divergent jumps and loop frames indexed at run time
// (local memory).  The design below amortises all but the row's own loads
// and compare over V rows.
//
// Design: a thread owns V = ROWS = 8 rows of one constraint row (an item) and
// decodes each instruction once for all V: the operand's kind is read
// once an instruction, every loop over the V rows is unrolled, and the V
// rows' boolean stack is one 64-bit word, V bits a level (a word a row for
// a program deeper than 64 / V levels), so nothing is indexed at run time.
// Where R >= 32 V a warp's 32 items are 32 V consecutive rows, lane i of
// thread t on row 32 i + t, so that each access of a row-major [R, S] or
// [R, K] operand reads 32 consecutive rows; for a smaller R (a review's 8
// rows) an item is V consecutive rows, whose mask and scalar type column
// move in one access, and a block's threads spread over constraint rows.
// String ids and numbers load only for the live rows whose type reads
// them.  Control is warp-uniform: a jump is taken only where every live
// row of the warp takes it (__all_sync), and a loop goes on while any
// live row's accumulator is False; a row whose value is decided runs on
// through the rest of its clause or loop, which cannot change it: the
// functions are pure, AND with False stays False, OR with True stays True.
// LOOP and ENDLOOP carry the loop's axis, mask, body and nesting depth, so
// no frame is kept; the index an inner loop hides is saved per depth in
// registers.
// A block is 256 threads on the items of ONE group, staging its code and
// operands in shared memory once; each thread walks up to ITEMS items,
// loading the next item's mask while the current one runs, and a thread
// whose rows are all match-False skips the program (pad rows are).
//
// Review mode (a packed output given): the review's two masks leave the
// card bit-packed, as gatekeeper_tpu/ops/driver.py _packed_variant packs
// them inside the review's one jitted dispatch, so K9 packs them in its
// own launch and the review launches no K10.  No block waits for another:
// the thread that finishes an item packs its rows' bytes from its
// registers (V = 8 consecutive rows are one packed byte; in the STEP-32
// layout a warp's 256 rows are 32 bytes, gathered by 8 shuffles), and
// their autoreject bytes from memory with K10's body (packbits.cuh), K1
// having written the autoreject mask in an earlier launch; every block
// first packs a share of the rows of no group (ranges after the code in
// the blob), which K9 does not write.  Without an output (a sweep) none
// of this runs.
//
// Delta mode (a delta output given; a separate instantiation, so a
// sweep's and a review's code is unchanged): the incremental audit's
// before | after columns of the w dirty rows, int8 [C, 2w], which
// gatekeeper_tpu/ops/driver.py _delta_fn gathers and concatenates in the
// same jitted dispatch as the evaluation of the w-row slice, and which
// K5 (delta.cu) writes in a launch of its own after K9 where this mode
// does not run.  The thread that finishes an item writes its rows'
// after-bytes from its registers.  The before-bytes, resident[c, idx[j]]
// from the full sweep's resident mask, depend on no program: extra blocks
// past the groups' gather them for every row, V columns a thread, and
// write both halves of the rows of no group.  A delta launch's group
// blocks are few (16 at w = 256, one a group at w = 8), so the extra
// blocks run on SMs that would idle, beside the groups' items, and no
// block waits for another.  (Gathering an item's before-bytes in its own
// thread, loaded with its mask bytes while the item before it ran, lost
// 0.007-0.018 ms at w = 256: PERF.md, K9's delta mode.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "packbits.cuh"
#include "setcount.cuh"
#include "strpred.cuh"

namespace {

// ops/progcode.py's encoding
constexpr int WIDTH = 6;
enum Opcode {
  I_CONST = 0, I_TRUTHY, I_CMP, I_STRPRED, I_SETCOUNT, I_JOIN, I_AND, I_OR,
  I_NOT, I_JFALSE, I_JTRUE, I_LOOP, I_ENDLOOP, I_HALT
};
// ops/program.py's operand kinds and layout
enum Kind {
  K_SCALAR = 0, K_SLOT, K_PARAM, K_ELEM, K_LITSTR, K_CONST, K_MASK_S,
  K_MASK_P, K_TABLE, K_SETCOUNT, K_JOIN
};
constexpr int OPW = 8;   // int64 words an operand
constexpr int HDRW = 8;  // int64 words a group header
// ops/columns.py's type codes; joinkernel.UNKNOWN_KEY
constexpr int T_UNDEF = 0, T_FALSE = 2, T_TRUE = 3, T_NUM = 4, T_STR = 5,
              T_COMP = 6;
constexpr int UNKNOWN_KEY = -5;

// rows an item (V), threads a block, and items (V-row tiles of a
// constraint row) a thread walks at most (ops/program.py ROWS_PER_THREAD,
// THREADS, ITEMS)
constexpr int ROWS = 8;
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Val {
  int t;
  int sid;
  double num;
};

__device__ __forceinline__ int rank(int t) {
  t = min(max(t, 0), 6);
  return t - 1 - (t >= T_TRUE);
}

// OPA's cross-type order: ops/vexpr.py _cmp_values for one cell.  op:
// 0 ==, 1 !=, 2 <, 3 <=, 4 >, 5 >=.  The terms are combined with & and |
// on purpose: no short-circuit, so no branch a row.
__device__ __forceinline__ bool compare(const Val& a, const Val& b, int op,
                                        bool unk) {
  const int ra = rank(a.t), rb = rank(b.t);
  const bool defined = (a.t != T_UNDEF) & (b.t != T_UNDEF);
  const bool both_comp = (a.t == T_COMP) & (b.t == T_COMP);
  const bool same = ra == rb;
  // equal types (so equal ranks), and a number's or a string's value
  const bool eq = (a.t == b.t) & ((a.t != T_NUM) | (a.num == b.num)) &
                  ((a.t != T_STR) | (a.sid == b.sid));
  bool res, unknown;
  if (op <= 1) {
    res = op == 0 ? eq : !eq;
    unknown = both_comp;
  } else {
    const bool lt_val = ((a.t == T_NUM) & (a.num < b.num)) |
                        ((a.t == T_FALSE) & (b.t == T_TRUE));
    const bool lt = same ? lt_val : ra < rb;
    unknown = both_comp | (same & (a.t == T_STR));
    res = op == 2 ? lt : op == 3 ? (lt | eq) : op == 4 ? !(lt | eq) : !lt;
  }
  return unknown ? unk : (defined & res);
}

// V bytes moved as one word
template <int V> struct Word;
template <> struct Word<8> { typedef uint2 T; };
template <int V>
union Bytes {
  typename Word<V>::T w;
  uint8_t b[V];
};

template <int V>
__device__ __forceinline__ bool whole(const void* p, int n) {
  return n >= V && (reinterpret_cast<uintptr_t>(p) & (V - 1)) == 0;
}

// The V lanes' bytes p[STEP * i], lanes at or past n read as 0: for
// consecutive lanes (STEP 1) one access where the V bytes are aligned to
// V, else one a lane.
template <int V, int STEP>
__device__ __forceinline__ void load_bytes(const uint8_t* p, int n,
                                           uint8_t out[V]) {
  if (STEP == 1 && whole<V>(p, n)) {
    Bytes<V> u;
    u.w = *reinterpret_cast<const typename Word<V>::T*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = u.b[i];
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = i < n ? p[STEP * i] : 0;
  }
}

template <int V, int STEP>
__device__ __forceinline__ void store_bytes(uint8_t* p, int n,
                                            const uint8_t in[V]) {
  if (STEP == 1 && whole<V>(p, n)) {
    Bytes<V> u;
#pragma unroll
    for (int i = 0; i < V; ++i) u.b[i] = in[i];
    *reinterpret_cast<typename Word<V>::T*>(p) = u.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < n) p[STEP * i] = in[i];
  }
}

// The thread's V rows of one constraint row: c, lane i's row r0 + STEP * i,
// the n lanes in range, and the live ones (match bit set) as bits.
struct Rows {
  int c;
  long long r0;
  int n;
  unsigned live;
};

__device__ __forceinline__ bool on(unsigned bits, int i) {
  return (bits >> i) & 1u;
}

// The type codes of a value operand on the V rows, at slot s and
// parameter element p.
template <int V, int STEP>
__device__ __forceinline__ void load_t(const long long* o, const Rows& w,
                                       int s, int p, int t[V]) {
  const int kind = (int)o[0];
  const int8_t* tp = reinterpret_cast<const int8_t*>(o[1]);
  if (kind == K_SCALAR) {
    uint8_t b[V];
    load_bytes<V, STEP>(reinterpret_cast<const uint8_t*>(tp + w.r0), w.n, b);
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = (int)(int8_t)b[i];
  } else if (kind == K_SLOT) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      t[i] = on(w.live, i) ? tp[(w.r0 + STEP * i) * o[4] + s] : T_UNDEF;
  } else {
    int u;
    if (kind == K_PARAM) u = tp[w.c];
    else if (kind == K_ELEM) u = tp[(long long)w.c * o[4] + p];
    else if (kind == K_LITSTR) u = tp[0];
    else u = (int)o[5];
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = u;
  }
}

// A uniform operand's one value (uniform(o)): the string id read only for
// a string and the number only for a number.
__device__ __forceinline__ Val load_one(const long long* o, const Rows& w,
                                        int p) {
  const int kind = (int)o[0];
  if (kind <= K_LITSTR) {  // a parameter, an element or a string literal
    const long long j = kind == K_PARAM  ? w.c
                        : kind == K_ELEM ? (long long)w.c * o[4] + p
                                         : 0;
    Val u;
    u.t = reinterpret_cast<const int8_t*>(o[1])[j];
    u.sid = u.t == T_STR ? reinterpret_cast<const int*>(o[2])[j] : -1;
    u.num = (u.t == T_NUM && kind != K_LITSTR)
                ? reinterpret_cast<const double*>(o[3])[j]
                : 0.0;
    return u;
  }
  return Val{(int)o[5], (int)o[6], __longlong_as_double(o[7])};
}

// A value operand on the V rows.  The string id is read only for a live
// string and the number only for a live number: nothing reads them
// otherwise.
template <int V, int STEP>
__device__ __forceinline__ void load(const long long* o, const Rows& w, int s,
                                     int p, Val v[V]) {
  const int kind = (int)o[0];
  if (kind == K_SCALAR || kind == K_SLOT) {
    int t[V];
    load_t<V, STEP>(o, w, s, p, t);
    const int* sp = reinterpret_cast<const int*>(o[2]);
    const double* np = reinterpret_cast<const double*>(o[3]);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const long long r = w.r0 + STEP * i;
      const long long j = kind == K_SCALAR ? r : r * o[4] + s;
      v[i].t = t[i];
      v[i].sid = on(w.live, i) && t[i] == T_STR ? sp[j] : -1;
      v[i].num = on(w.live, i) && t[i] == T_NUM ? np[j] : 0.0;
    }
    return;
  }
  const Val u = load_one(o, w, p);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = u;
}

// Bit i: the loop mask at element idx for row i.
template <int V, int STEP>
__device__ __forceinline__ unsigned mask_bits(const long long* m,
                                              const Rows& w, int idx) {
  const uint8_t* a = reinterpret_cast<const uint8_t*>(m[1]);
  if ((int)m[0] == K_MASK_S) {
    unsigned b = 0;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (on(w.live, i) && a[(w.r0 + STEP * i) * m[4] + idx]) b |= 1u << i;
    return b;
  }
  return a[(long long)w.c * m[4] + idx] ? (1u << V) - 1u : 0u;
}

// The boolean stack of the thread's V rows, two ways.  A level is V bits,
// bit i for row i.  PackedStack holds level k in bits [kV, kV + V) of one
// 64-bit word, so each operation is a few instructions for all V rows, up
// to 64 / V levels; LaneStack holds a word a row, up to 32 levels (the
// bytecode's MAX_STACK).
template <int V>
struct PackedStack {
  static constexpr unsigned long long M = (1ull << V) - 1ull;
  unsigned long long s = 0;
  __device__ __forceinline__ void push(unsigned bits) {
    s = (s << V) | (bits & M);
  }
  __device__ __forceinline__ unsigned top() const { return (unsigned)(s & M); }
  __device__ __forceinline__ void and_() { s = (s >> V) & (~M | (s & M)); }
  __device__ __forceinline__ void or_() { s = (s >> V) | (s & M); }
  __device__ __forceinline__ void not_() { s ^= M; }
};

template <int V>
struct LaneStack {
  unsigned st[V];
  __device__ __forceinline__ LaneStack() {
#pragma unroll
    for (int i = 0; i < V; ++i) st[i] = 0;
  }
  __device__ __forceinline__ void push(unsigned bits) {
#pragma unroll
    for (int i = 0; i < V; ++i) st[i] = (st[i] << 1) | ((bits >> i) & 1u);
  }
  __device__ __forceinline__ unsigned top() const {
    unsigned b = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) b |= (st[i] & 1u) << i;
    return b;
  }
  __device__ __forceinline__ void and_() {
#pragma unroll
    for (int i = 0; i < V; ++i) st[i] = (st[i] >> 1) & (~1u | st[i]);
  }
  __device__ __forceinline__ void or_() {
#pragma unroll
    for (int i = 0; i < V; ++i) st[i] = (st[i] >> 1) | (st[i] & 1u);
  }
  __device__ __forceinline__ void not_() {
#pragma unroll
    for (int i = 0; i < V; ++i) st[i] ^= 1u;
  }
};

// A parameter, an element, a literal or a constant: one value for all V
// rows.
__device__ __forceinline__ bool uniform(const long long* o) {
  return (int)o[0] >= K_PARAM;
}

template <int V, int OP>
__device__ __forceinline__ unsigned cmp_one(const Val a[V], const Val& b,
                                            bool unk) {
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) r |= (unsigned)compare(a[i], b, OP, unk) << i;
  return r;
}

template <int V, int OP>
__device__ __forceinline__ unsigned cmp_all(const Val a[V], const Val b[V],
                                            bool unk) {
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < V; ++i)
    r |= (unsigned)compare(a[i], b[i], OP, unk) << i;
  return r;
}

// the comparison with its operator made a constant: against one value
// for all V rows, or against V values
template <int V>
__device__ __forceinline__ unsigned cmp_one_op(int op, const Val a[V],
                                               const Val& b, bool unk) {
  switch (op) {
    case 0: return cmp_one<V, 0>(a, b, unk);
    case 1: return cmp_one<V, 1>(a, b, unk);
    case 2: return cmp_one<V, 2>(a, b, unk);
    case 3: return cmp_one<V, 3>(a, b, unk);
    case 4: return cmp_one<V, 4>(a, b, unk);
    default: return cmp_one<V, 5>(a, b, unk);
  }
}

template <int V>
__device__ __forceinline__ unsigned cmp_all_op(int op, const Val a[V],
                                               const Val b[V], bool unk) {
  switch (op) {
    case 0: return cmp_all<V, 0>(a, b, unk);
    case 1: return cmp_all<V, 1>(a, b, unk);
    case 2: return cmp_all<V, 2>(a, b, unk);
    case 3: return cmp_all<V, 3>(a, b, unk);
    case 4: return cmp_all<V, 4>(a, b, unk);
    default: return cmp_all<V, 5>(a, b, unk);
  }
}

// The index a loop of depth d hides, in one of four registers
__device__ __forceinline__ void save(int d, int v, int sv[4]) {
  if (d == 0) sv[0] = v;
  else if (d == 1) sv[1] = v;
  else if (d == 2) sv[2] = v;
  else sv[3] = v;
}

__device__ __forceinline__ int saved(int d, const int sv[4]) {
  return d == 0 ? sv[0] : d == 1 ? sv[1] : d == 2 ? sv[2] : sv[3];
}

// The program on the thread's V rows -> bit i: row i's value.  Every
// thread of ``active`` (the warp's threads with a live row) runs the same
// instructions.
template <int V, int STEP, typename Stack>
__device__ __forceinline__ unsigned run(const int* __restrict__ code,
                                        const long long* __restrict__ ops,
                                        const Rows& w, unsigned active) {
  Stack st;
  int s = 0, p = 0;
  int sv[4] = {0, 0, 0, 0};
  int pc = 0;
  while (true) {
    const int* ins = code + pc * WIDTH;
    ++pc;
    switch (ins[0]) {
      case I_CONST:
        st.push(ins[1] != 0 ? FULL : 0u);
        break;
      case I_TRUTHY: {
        int t[V];
        load_t<V, STEP>(ops + ins[1] * OPW, w, s, p, t);
        const bool neg = ins[2] != 0;
        unsigned b = 0;
#pragma unroll
        for (int i = 0; i < V; ++i)
          b |= (unsigned)((t[i] != T_UNDEF && t[i] != T_FALSE) != neg) << i;
        st.push(b);
        break;
      }
      case I_CMP: {
        Val a[V];
        load<V, STEP>(ops + ins[3] * OPW, w, s, p, a);
        const long long* ob = ops + ins[4] * OPW;
        const bool unk = ins[2] != 0;
        if (uniform(ob)) {
          st.push(cmp_one_op<V>(ins[1], a, load_one(ob, w, p), unk));
        } else {
          Val b[V];
          load<V, STEP>(ob, w, s, p, b);
          st.push(cmp_all_op<V>(ins[1], a, b, unk));
        }
        break;
      }
      case I_STRPRED: {
        Val v[V];
        load<V, STEP>(ops + ins[1] * OPW, w, s, p, v);
        const long long* tb = ops + ins[2] * OPW;
        const int* idx = reinterpret_cast<const int*>(tb[4]);
        const int col = tb[5] ? idx[(long long)w.c * tb[5] + p] : idx[w.c];
        const uint8_t* table = reinterpret_cast<const uint8_t*>(tb[1]);
        const bool neg = ins[3] != 0;
        unsigned r = 0;
#pragma unroll
        for (int i = 0; i < V; ++i)
          r |= (unsigned)gk::strpred_cell(table, (int)tb[2], (int)tb[3], col,
                                          v[i].t, v[i].sid, neg)
               << i;
        st.push(r);
        break;
      }
      case I_SETCOUNT: {
        const long long* o = ops + ins[1] * OPW;
        const int P = (int)o[4], K = (int)o[5];
        const int* ci = reinterpret_cast<const int*>(o[1]) + (long long)w.c * P;
        const uint8_t* cm =
            reinterpret_cast<const uint8_t*>(o[2]) + (long long)w.c * P;
        const int* kr = reinterpret_cast<const int*>(o[3]);
        const int pad = (int)(o[7] >> 32), orient = (int)(o[6] & 15);
        const int cop = (int)(o[6] >> 4);
        const int n = (int)(unsigned)(o[7] & 0xffffffffLL);
        unsigned r = 0;
        // one row at a time
#pragma unroll 1
        for (int i = 0; i < V; ++i) {
          if (!on(w.live, i)) continue;
          const int* row = kr + (w.r0 + STEP * i) * K;
          const int cnt =
              gk::setcount_count(ci, cm, P, row, K, pad, orient);
          r |= (unsigned)gk::setcount_compare(cnt, cop, n) << i;
        }
        st.push(r);
        break;
      }
      case I_JOIN: {
        const long long* o = ops + ins[1] * OPW;
        const bool unk = ins[3] != 0;
        if (!o[4]) {
          st.push(unk ? FULL : 0u);
          break;
        }
        Val b[V];
        load<V, STEP>(ops + ins[4] * OPW, w, s, p, b);
        const int* qp = reinterpret_cast<const int*>(o[1]);
        const int* cp = reinterpret_cast<const int*>(o[2]);
        unsigned r = 0;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          bool v = unk;
          if (on(w.live, i)) {
            const long long r = w.r0 + STEP * i;
            const long long j = o[3] ? r * o[3] + s : r;
            const int q = qp[j];
            if (q != UNKNOWN_KEY) {
              const Val lhs{q >= 0 ? T_NUM : T_UNDEF, -1,
                            q >= 0 ? (double)cp[j] : 0.0};
              v = compare(lhs, b[i], ins[2], unk);
            }
          }
          r |= (unsigned)v << i;
        }
        st.push(r);
        break;
      }
      case I_AND:
        st.and_();
        break;
      case I_OR:
        st.or_();
        break;
      case I_NOT:
        st.not_();
        break;
      case I_JFALSE:
        if (__all_sync(active, (w.live & st.top()) == 0)) pc = ins[1];
        break;
      case I_JTRUE:
        if (__all_sync(active, (w.live & ~st.top()) == 0)) pc = ins[1];
        break;
      case I_LOOP: {  // axis, mask, end, depth
        const long long* m = ops + ins[2] * OPW;
        st.push(0u);  // the accumulator, False
        if (m[4] == 0) {
          pc = ins[3];
          break;
        }
        if (ins[1] == 0) {
          save(ins[4], p, sv);
          p = 0;
        } else {
          save(ins[4], s, sv);
          s = 0;
        }
        st.push(mask_bits<V, STEP>(m, w, 0));
        break;
      }
      case I_ENDLOOP: {  // axis, mask, body, depth
        st.or_();  // the element's value into the accumulator
        const long long* m = ops + ins[2] * OPW;
        const int idx = (ins[1] == 0 ? p : s) + 1;
        if (idx < (int)m[4] &&
            __any_sync(active, (w.live & ~st.top()) != 0)) {
          if (ins[1] == 0) p = idx;
          else s = idx;
          st.push(mask_bits<V, STEP>(m, w, idx));
          pc = ins[3];
        } else if (ins[1] == 0) {
          p = saved(ins[4], sv);
        } else {
          s = saved(ins[4], sv);
        }
        break;
      }
      default:  // I_HALT
        return st.top();
    }
  }
}

// Review mode, before the walk: the packed bytes of the mask rows no
// group covers, and of their autoreject rows, spread over every thread of
// the launch.  ``tail`` is the word after the code (ops/program.py
// pack_launch): U, then U (begin, end) ranges of such rows.
__device__ void pack_rows_of_no_group(const long long* tail,
                                      const uint8_t* mask,
                                      const uint8_t* autoreject,
                                      uint8_t* out, int C, int R, int vec) {
  const long long U = tail[0];
  const long long* ranges = tail + 1;
  long long n = 0;
  for (long long u = 0; u < U; ++u) n += ranges[2 * u + 1] - ranges[2 * u];
  const long long RB = (R + 7) / 8;
  for (long long f = (long long)blockIdx.x * THREADS + threadIdx.x;
       f < 2 * n * RB; f += (long long)gridDim.x * THREADS) {
    long long q = f / RB;
    const long long j = f - q * RB;
    const bool rej = q >= n;
    if (rej) q -= n;
    long long row = 0;
    for (long long u = 0; u < U; ++u) {
      const long long len = ranges[2 * u + 1] - ranges[2 * u];
      if (q < len) {
        row = ranges[2 * u] + q;
        break;
      }
      q -= len;
    }
    const long long t = (rej ? C + row : row) * RB + j;
    out[t] = gk::pack_byte(mask, autoreject, C, R, vec, t);
  }
}

// Review mode, after an item: its rows' packed mask byte, from the final
// mask bits ``fin`` of the thread's V rows (bit i: row r0 + STEP * i), and
// the same columns' autoreject byte, from memory.  STEP 1: the V = 8 rows
// r0 .. r0 + 7 are one byte.  STEP 32: the warp's 32 items are rows
// base .. base + 255 of one constraint row, lane t holding rows base +
// 32 i + t; lane b packs rows base + 8b .. + 7, gathered by shuffles from
// lanes 8 (b % 4) + k, bit b / 4.  ``valid``: the item is one of the
// group's (warp-uniform for STEP 32, where every lane shuffles).
template <int V, int STEP>
__device__ __forceinline__ void pack_item(unsigned fin, const Rows& w,
                                          bool valid, long long row,
                                          const uint8_t* mask,
                                          const uint8_t* autoreject,
                                          uint8_t* out, int C, int R,
                                          int vec) {
  static_assert(V == 8, "an item's V rows are one packed byte");
  const int lane = threadIdx.x & 31;
  uint8_t bits[8];
  if (STEP == 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) bits[i] = on(fin, i);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      bits[k] = on(__shfl_sync(FULL, fin, 8 * (lane & 3) + k), lane >> 2);
  }
  const long long col = STEP == 1 ? w.r0 : w.r0 - lane + 8 * lane;
  if (!valid || col >= R) return;
  const long long RB = (R + 7) / 8;
  out[row * RB + col / 8] = gk::pack8(bits);
  const long long t = (C + row) * RB + col / 8;
  out[t] = gk::pack_byte(mask, autoreject, C, R, vec, t);
}

// Delta mode, after an item: its rows' after-bytes, the final mask bits
// ``fin``, into row ``row`` of dout [C, 2R], columns R + r0 + STEP * i.
template <int V, int STEP>
__device__ __forceinline__ void delta_item(unsigned fin, const Rows& w,
                                           long long row, int R,
                                           int8_t* dout) {
  uint8_t a[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = on(fin, i);
  store_bytes<V, STEP>(
      reinterpret_cast<uint8_t*>(dout) + row * 2LL * R + R + w.r0, w.n, a);
}

// Delta mode, the blocks past the groups' (``first`` the first of ``nb``),
// V consecutive columns of a row a unit: the before-bytes of every row,
// gathered from the resident mask, and the after-bytes of the rows that
// no group covers, the launch's mask as K1 left it.  ``tail`` as in
// pack_rows_of_no_group.
__device__ void delta_gather(const long long* tail, const uint8_t* mask,
                             int C, int R, const uint8_t* resident,
                             long long Rt, const int* idx, int8_t* dout,
                             unsigned first, unsigned nb) {
  const long long U = tail[0];
  const long long* ranges = tail + 1;
  const long long per = (R + ROWS - 1) / ROWS;  // units a row
  for (long long f = (long long)(blockIdx.x - first) * THREADS + threadIdx.x;
       f < (long long)C * per; f += (long long)nb * THREADS) {
    const long long row = f / per;
    const int j0 = (int)(f - row * per) * ROWS;
    const int cnt = min(ROWS, R - j0);
    const uint8_t* res = resident + row * Rt;
    uint8_t b[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) b[i] = i < cnt ? res[idx[j0 + i]] != 0 : 0;
    uint8_t* o = reinterpret_cast<uint8_t*>(dout) + row * 2LL * R + j0;
    store_bytes<ROWS, 1>(o, cnt, b);
    bool no_group = false;
    for (long long u = 0; u < U; ++u)
      no_group |= ranges[2 * u] <= row && row < ranges[2 * u + 1];
    if (no_group) {
      uint8_t a[ROWS];
      load_bytes<ROWS, 1>(mask + row * R + j0, cnt, a);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = a[i] != 0;
      store_bytes<ROWS, 1>(o + R, cnt, a);
    }
  }
}

// Lane i of an item is row r0 + STEP * i.  STEP 1: an item is V
// consecutive rows (a review's 8 rows fill threads on several constraint
// rows, and 1-D columns and the mask move V bytes an access); STEP 32: a
// warp's item is 32 * V consecutive rows, lane i of thread t row
// 32 * i + t, so that each access of a row-major [R, S] or [R, K] operand
// reads 32 consecutive rows.  The launcher takes STEP 32 where R >= 32 V.
// DELTA: the delta mode's instantiation (resident, Rt, idx and dout
// given, and blocks past ``nblocks``, the groups' blocks, for the gather).
template <int V, int STEP, bool DELTA>
__global__ void __launch_bounds__(THREADS)
    program_kernel(const long long* __restrict__ blob, int G, int NOP,
                   uint8_t* __restrict__ mask, int R, int max_ops,
                   const uint8_t* __restrict__ autoreject,
                   uint8_t* __restrict__ pout, int C, int vec, int nblocks,
                   const uint8_t* __restrict__ resident, long long Rt,
                   const int* __restrict__ idx, int8_t* __restrict__ dout) {
  extern __shared__ long long sh[];
  long long* ops = sh;                                // [max_ops * OPW]
  int* code = reinterpret_cast<int*>(sh + (long long)max_ops * OPW);
  if (DELTA && blockIdx.x >= (unsigned)nblocks) {
    // the word after the code, as in review mode below
    const long long* hl = blob + (long long)(G - 1) * HDRW;
    delta_gather(blob + (long long)G * HDRW + (long long)NOP * OPW +
                     (hl[3] + hl[4] + 1) / 2,
                 mask, C, R, resident, Rt, idx, dout, nblocks,
                 gridDim.x - nblocks);
    return;
  }
  // the block's group: the last whose first block is not after this one
  int g = 0, hi = G - 1;
  while (g < hi) {
    const int mid = (g + hi + 1) >> 1;
    if (blob[(long long)mid * HDRW + 2] <= (long long)blockIdx.x) g = mid;
    else hi = mid - 1;
  }
  const long long* h = blob + (long long)g * HDRW;
  const int n_code = (int)h[4], n_op = (int)h[6];
  const long long* g_ops = blob + (long long)G * HDRW + h[5] * OPW;
  const int* g_code = reinterpret_cast<const int*>(
                          blob + (long long)G * HDRW + (long long)NOP * OPW) +
                      h[3];
  for (int i = threadIdx.x; i < n_op * OPW; i += THREADS) ops[i] = g_ops[i];
  for (int i = threadIdx.x; i < n_code; i += THREADS) code[i] = g_code[i];
  if (!DELTA && pout != nullptr) {
    // the word after the code: the last group's code ends it, padded to
    // whole words
    const long long* hl = blob + (long long)(G - 1) * HDRW;
    pack_rows_of_no_group(
        blob + (long long)G * HDRW + (long long)NOP * OPW +
            (hl[3] + hl[4] + 1) / 2,
        mask, autoreject, pout, C, R, vec);
  }
  __syncthreads();

  // the group's items, per_row to a constraint row, walked by the group's
  // blocks in turn (ops/program.py group_blocks counts them alike)
  const unsigned B = (unsigned)h[1];
  const unsigned per_row =
      STEP == 1 ? (unsigned)((R + V - 1) / V)
                : (unsigned)((R + 32 * V - 1) / (32 * V)) * 32u;
  const unsigned items = B * per_row;  // < 2^31: the wrapper checks it
  const unsigned first = (unsigned)h[2];
  const unsigned last = g + 1 < G
                            ? (unsigned)blob[(long long)(g + 1) * HDRW + 2]
                            : (unsigned)nblocks;
  const unsigned stride = (last - first) * THREADS;
  const bool packed = h[7] <= 64 / V;  // the stack fits one word
  unsigned item = (blockIdx.x - first) * THREADS + threadIdx.x;
  uint8_t m[V], next[V];
  Rows w;
  uint8_t* row = nullptr;
  // an item's rows and mask bytes; each item's are loaded while the one
  // before it runs
  auto fetch = [&](unsigned it, Rows& x, uint8_t*& at, uint8_t out[V]) {
    const bool in = it < items;
    const unsigned c = in ? it / per_row : B - 1;
    const unsigned k = in ? it % per_row : 0;
    x.c = (int)c;
    x.r0 = STEP == 1 ? (long long)k * V
                     : (long long)(k / 32) * (32 * V) + (k % 32);
    x.n = x.r0 < R ? (int)min((long long)V, (R - x.r0 + STEP - 1) / STEP) : 0;
    at = mask + (h[0] + c) * (long long)R + x.r0;
    x.live = 0;
    if (in) {
      load_bytes<V, STEP>(at, x.n, out);
#pragma unroll
      for (int i = 0; i < V; ++i) x.live |= (unsigned)(out[i] != 0) << i;
    }
  };
  fetch(item, w, row, m);
  while (__any_sync(FULL, item < items)) {
    Rows wn;
    uint8_t* row_n;
    fetch(item + stride, wn, row_n, next);
    const unsigned active = __ballot_sync(FULL, w.live != 0);
    unsigned fin = 0;  // the V rows' final mask bits
    if (w.live) {
      const unsigned res =
          packed ? run<V, STEP, PackedStack<V>>(code, ops, w, active)
                 : run<V, STEP, LaneStack<V>>(code, ops, w, active);
      fin = w.live & res;
      if (w.live & ~res) {  // only rows that turn False are written
#pragma unroll
        for (int i = 0; i < V; ++i) m[i] = on(fin, i) ? 1 : 0;
        store_bytes<V, STEP>(row, w.n, m);
      }
    }
    if (DELTA) {
      if (item < items) delta_item<V, STEP>(fin, w, h[0] + w.c, R, dout);
    } else if (pout != nullptr) {
      pack_item<V, STEP>(fin, w, item < items, h[0] + w.c, mask, autoreject,
                         pout, C, R, vec);
    }
    item += stride;
    w = wn;
    row = row_n;
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = next[i];
  }
}

struct Pack {
  const uint8_t* autoreject;
  uint8_t* out;
  int C, vec;
};

struct Delta {
  const uint8_t* resident;
  long long Rt;
  const int* idx;
  int8_t* out;
  int extra;  // blocks past the groups' for the rows of no group
};

template <int V, int STEP, bool DELTA>
int launch_step(const long long* blob, int G, int NOP, uint8_t* mask, int R,
                int blocks, size_t smem, int max_ops, const Pack& pk,
                const Delta& dl, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        program_kernel<V, STEP, DELTA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)blocks + (DELTA ? (unsigned)dl.extra : 0u);
  program_kernel<V, STEP, DELTA><<<grid, THREADS, smem, stream>>>(
      blob, G, NOP, mask, R, max_ops, pk.autoreject, pk.out, pk.C, pk.vec,
      blocks, dl.resident, dl.Rt, dl.idx, dl.out);
  return cudaGetLastError();
}

template <bool DELTA>
int launch_mode(const long long* blob, int G, int NOP, uint8_t* mask, int R,
                int blocks, size_t smem, int max_ops, const Pack& pk,
                const Delta& dl, cudaStream_t stream) {
  return R >= 32 * ROWS
             ? launch_step<ROWS, 32, DELTA>(blob, G, NOP, mask, R, blocks,
                                            smem, max_ops, pk, dl, stream)
             : launch_step<ROWS, 1, DELTA>(blob, G, NOP, mask, R, blocks,
                                           smem, max_ops, pk, dl, stream);
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// blob: G headers of HDRW words (mask row start, B, the group's first
// block, code offset and length in int32 words, operand offset and count,
// stack depth), then NOP operands of OPW words, then the code, then U and
// U (begin, end) ranges of the mask rows no group covers (review mode).
// blocks: the sum over the groups of ops/program.py group_blocks(B, R);
// max_code / max_ops: the largest group's code words and operands (the
// shared memory a block takes).
// out: null for a sweep; for a review the uint8[2C, ceil(R/8)] packed
// masks, the mask [C, R] and autoreject [C, R] packed into it.
// dout: null but in delta mode, then the int8[C, 2R] before | after
// columns: dout[c, j] = resident[c, idx[j]] (resident bool [C, Rt], idx
// int32 [R] in [0, Rt)) and dout[c, R + j] = mask[c, j] after the groups;
// ``extra`` blocks after the ``blocks`` of the groups gather the
// before-bytes and write the rows of no group.  C is the mask's rows in
// both modes.  A launch passes out or dout, not both.
extern "C" int gk_program_launch(const long long* blob, int G, int NOP,
                                 uint8_t* mask, int R, int blocks,
                                 int max_code, int max_ops,
                                 const uint8_t* autoreject, uint8_t* out,
                                 int C, const uint8_t* resident, int Rt,
                                 const int* idx, int8_t* dout, int extra,
                                 void* stream) {
  if (G <= 0 || blocks <= 0 || R <= 0) return 0;
  if (out != nullptr && dout != nullptr) return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)max_ops * OPW * sizeof(long long) + (size_t)max_code * 4;
  const int vec = R % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(mask) |
                    reinterpret_cast<uintptr_t>(autoreject)) & 7) == 0;
  const Pack pk{autoreject, out, C, vec};
  const Delta dl{resident, Rt, idx, dout, extra};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dout != nullptr
             ? launch_mode<true>(blob, G, NOP, mask, R, blocks, smem, max_ops,
                                 pk, dl, s)
             : launch_mode<false>(blob, G, NOP, mask, R, blocks, smem,
                                  max_ops, pk, dl, s);
}
