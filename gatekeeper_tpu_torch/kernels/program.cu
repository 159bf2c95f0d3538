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
// Replaces gatekeeper_tpu/ops/vexpr.py eval_program (with _eval_node and
// _cmp_values), which XLA fused into the sweep's executable under jax.jit
// (gatekeeper_tpu/ops/driver.py _eval_body).  Run op by op in eager
// PyTorch the same IR issues some 600 launches an evaluation.  This is not
// a carry-over of that structure: one interpreter runs every program,
// built once with the other kernels, so a new template needs no compile.
//
// What bounds it: on paper, bytes: the group rows of the mask read and
// written (2 bytes a cell) and the columns each group reads once (a few
// bytes a row).  In practice the interpreter's instructions: each cell
// decodes and dispatches every instruction it reaches (tens a cell), and
// loads its operands through a switch on their kind.
//
// Design: one block for one padded constraint row c of a group and a tile
// of THREADS * ROWS_PER_THREAD rows, so every thread of a block runs the
// same instructions (warp-uniform decode; only data-dependent jumps and
// selects differ).  The block copies its group's stream and operand table
// into shared memory.  A cell whose match bit is already False is skipped
// (AND keeps it False; pad rows are match-False); a clause stops at its
// first False condition, the program at its first True clause, a loop at
// its first True element.  Values load lazily: a string id only for a
// string, a number only for a number, which is all the comparison reads.
// Only a cell that turns False is written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "setcount.cuh"
#include "strpred.cuh"

namespace {

// ops/progcode.py's encoding
constexpr int WIDTH = 6;
constexpr int MAX_LOOPS = 4;
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

constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 4;
constexpr int TILE = THREADS * ROWS_PER_THREAD;

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
// 0 ==, 1 !=, 2 <, 3 <=, 4 >, 5 >=.
__device__ __forceinline__ bool compare(const Val& a, const Val& b, int op,
                                        bool unk) {
  const int ra = rank(a.t), rb = rank(b.t);
  const bool defined = a.t != T_UNDEF && b.t != T_UNDEF;
  const bool both_comp = a.t == T_COMP && b.t == T_COMP;
  const bool same = ra == rb;
  const bool eq_val = a.t == T_NUM   ? a.num == b.num
                      : a.t == T_STR ? a.sid == b.sid
                                     : a.t == b.t;
  const bool eq = same && eq_val && a.t == b.t;
  bool res, unknown;
  if (op <= 1) {
    res = op == 0 ? eq : !eq;
    unknown = both_comp;
  } else {
    const bool lt_val =
        a.t == T_NUM ? a.num < b.num : (a.t == T_FALSE && b.t == T_TRUE);
    const bool lt = same ? lt_val : ra < rb;
    unknown = both_comp || (same && a.t == T_STR);
    res = op == 2 ? lt : op == 3 ? (lt || eq) : op == 4 ? (!lt && !eq) : !lt;
  }
  return unknown ? unk : (defined && res);
}

// A value operand at cell (c, r), slot s, parameter element p.  The string
// id is read only for a string and the number only for a number: nothing
// reads them otherwise.
__device__ __forceinline__ Val load(const long long* o, int c, long long r,
                                    int s, int p) {
  long long i;
  switch ((int)o[0]) {
    case K_SCALAR: i = r; break;
    case K_SLOT: i = r * o[4] + s; break;
    case K_PARAM: i = c; break;
    case K_ELEM: i = (long long)c * o[4] + p; break;
    case K_LITSTR: i = 0; break;
    default:
      return Val{(int)o[5], (int)o[6], __longlong_as_double(o[7])};
  }
  Val v;
  v.t = reinterpret_cast<const int8_t*>(o[1])[i];
  v.sid = v.t == T_STR ? reinterpret_cast<const int*>(o[2])[i] : -1;
  v.num = (v.t == T_NUM && o[0] != K_LITSTR)
              ? reinterpret_cast<const double*>(o[3])[i]
              : 0.0;
  return v;
}

__device__ __forceinline__ int load_t(const long long* o, int c,
                                      long long r, int s, int p) {
  switch ((int)o[0]) {
    case K_SCALAR: return reinterpret_cast<const int8_t*>(o[1])[r];
    case K_SLOT: return reinterpret_cast<const int8_t*>(o[1])[r * o[4] + s];
    case K_PARAM: return reinterpret_cast<const int8_t*>(o[1])[c];
    case K_ELEM:
      return reinterpret_cast<const int8_t*>(o[1])[(long long)c * o[4] + p];
    case K_LITSTR: return reinterpret_cast<const int8_t*>(o[1])[0];
    default: return (int)o[5];
  }
}

__device__ __forceinline__ bool mask_bit(const long long* m, int c,
                                         long long r, int idx) {
  const uint8_t* a = reinterpret_cast<const uint8_t*>(m[1]);
  return (int)m[0] == K_MASK_S ? a[r * m[4] + idx] != 0
                               : a[(long long)c * m[4] + idx] != 0;
}

// One cell's program: the stack is the bits of one word, its top bit 0.
__device__ __forceinline__ bool run(const int* __restrict__ code,
                                    const long long* __restrict__ ops, int c,
                                    long long r) {
  unsigned st = 0;
  int s = 0, p = 0, depth = 0;
  int f_axis[MAX_LOOPS], f_m[MAX_LOOPS], f_body[MAX_LOOPS],
      f_saved[MAX_LOOPS];
  int pc = 0;
  while (true) {
    const int* ins = code + pc * WIDTH;
    ++pc;
    switch (ins[0]) {
      case I_CONST:
        st = (st << 1) | (unsigned)(ins[1] != 0);
        break;
      case I_TRUTHY: {
        const int t = load_t(ops + ins[1] * OPW, c, r, s, p);
        const bool v = t != T_UNDEF && t != T_FALSE;
        st = (st << 1) | (unsigned)(v != (ins[2] != 0));
        break;
      }
      case I_CMP: {
        const Val a = load(ops + ins[3] * OPW, c, r, s, p);
        const Val b = load(ops + ins[4] * OPW, c, r, s, p);
        st = (st << 1) | (unsigned)compare(a, b, ins[1], ins[2] != 0);
        break;
      }
      case I_STRPRED: {
        const Val v = load(ops + ins[1] * OPW, c, r, s, p);
        const long long* tb = ops + ins[2] * OPW;
        const int* idx = reinterpret_cast<const int*>(tb[4]);
        const int col = tb[5] ? idx[(long long)c * tb[5] + p] : idx[c];
        st = (st << 1) |
             (unsigned)gk::strpred_cell(
                 reinterpret_cast<const uint8_t*>(tb[1]), (int)tb[2],
                 (int)tb[3], col, v.t, v.sid, ins[3] != 0);
        break;
      }
      case I_SETCOUNT: {
        const long long* o = ops + ins[1] * OPW;
        const int P = (int)o[4], K = (int)o[5];
        const int cnt = gk::setcount_count(
            reinterpret_cast<const int*>(o[1]) + (long long)c * P,
            reinterpret_cast<const uint8_t*>(o[2]) + (long long)c * P, P,
            reinterpret_cast<const int*>(o[3]) + r * K, K,
            (int)(o[7] >> 32), (int)(o[6] & 15));
        const int n = (int)(unsigned)(o[7] & 0xffffffffLL);
        st = (st << 1) |
             (unsigned)gk::setcount_compare(cnt, (int)(o[6] >> 4), n);
        break;
      }
      case I_JOIN: {
        const long long* o = ops + ins[1] * OPW;
        const bool unk = ins[3] != 0;
        bool v = unk;
        if (o[4]) {
          const long long i = o[3] ? r * o[3] + s : r;
          const int q = reinterpret_cast<const int*>(o[1])[i];
          if (q != UNKNOWN_KEY) {
            const Val lhs{q >= 0 ? T_NUM : T_UNDEF, -1,
                          q >= 0 ? (double)reinterpret_cast<const int*>(
                                       o[2])[i]
                                 : 0.0};
            v = compare(lhs, load(ops + ins[4] * OPW, c, r, s, p), ins[2],
                        unk);
          }
        }
        st = (st << 1) | (unsigned)v;
        break;
      }
      case I_AND: {
        const unsigned y = st & 1u;
        st >>= 1;
        st &= ~1u | y;
        break;
      }
      case I_OR: {
        const unsigned y = st & 1u;
        st >>= 1;
        st |= y;
        break;
      }
      case I_NOT:
        st ^= 1u;
        break;
      case I_JFALSE:
        if (!(st & 1u)) pc = ins[1];
        break;
      case I_JTRUE:
        if (st & 1u) pc = ins[1];
        break;
      case I_LOOP: {
        const long long* m = ops + ins[2] * OPW;
        st <<= 1;  // the accumulator, False
        if (m[4] == 0) {
          pc = ins[3];
          break;
        }
        f_axis[depth] = ins[1];
        f_m[depth] = ins[2];
        f_body[depth] = pc;
        f_saved[depth] = ins[1] == 0 ? p : s;
        ++depth;
        if (ins[1] == 0) p = 0;
        else s = 0;
        st = (st << 1) | (unsigned)mask_bit(m, c, r, 0);
        break;
      }
      case I_ENDLOOP: {
        const unsigned part = st & 1u;
        st >>= 1;
        st |= part;  // the accumulator
        const int d = depth - 1;
        const long long* m = ops + f_m[d] * OPW;
        const int idx = (f_axis[d] == 0 ? p : s) + 1;
        if (!(st & 1u) && idx < (int)m[4]) {
          if (f_axis[d] == 0) p = idx;
          else s = idx;
          st = (st << 1) | (unsigned)mask_bit(m, c, r, idx);
          pc = f_body[d];
        } else {
          if (f_axis[d] == 0) p = f_saved[d];
          else s = f_saved[d];
          depth = d;
        }
        break;
      }
      default:  // I_HALT
        return st & 1u;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    program_kernel(const long long* __restrict__ blob, int G, int NOP,
                   uint8_t* __restrict__ mask, int R, int n_tiles,
                   int max_ops) {
  extern __shared__ long long sh[];
  long long* ops = sh;                                // [max_ops * OPW]
  int* code = reinterpret_cast<int*>(sh + (long long)max_ops * OPW);
  const long long gi = blockIdx.x / n_tiles;  // the block's group row
  const int tile = (int)(blockIdx.x % n_tiles);
  int g = 0;
  while (g + 1 < G && blob[(g + 1) * HDRW + 2] <= gi) ++g;
  const long long* h = blob + (long long)g * HDRW;
  const int c = (int)(gi - h[2]);
  const int n_code = (int)h[4], n_op = (int)h[6];
  const long long* g_ops = blob + (long long)G * HDRW + h[5] * OPW;
  const int* g_code = reinterpret_cast<const int*>(
                          blob + (long long)G * HDRW + (long long)NOP * OPW) +
                      h[3];
  for (int i = threadIdx.x; i < n_op * OPW; i += THREADS) ops[i] = g_ops[i];
  for (int i = threadIdx.x; i < n_code; i += THREADS) code[i] = g_code[i];
  __syncthreads();
  uint8_t* row = mask + (h[0] + c) * (long long)R;
  const long long base = (long long)tile * TILE + threadIdx.x;
#pragma unroll 1
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const long long r = base + k * THREADS;
    if (r >= R) break;
    if (row[r] && !run(code, ops, c, r)) row[r] = 0;
  }
}

}  // namespace

extern "C" const char* gk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// blob: G headers of HDRW words (mask row start, B, the group's first
// block row, code offset and length in int32 words, operand offset and
// count, stack depth), then NOP operands of OPW words, then the code.
// rows: the sum of B over the groups; max_code / max_ops: the largest
// group's code words and operands (the shared memory a block takes).
extern "C" int gk_program_launch(const long long* blob, int G, int NOP,
                                 uint8_t* mask, int R, int rows,
                                 int max_code, int max_ops, void* stream) {
  if (G <= 0 || rows <= 0 || R <= 0) return 0;
  const int n_tiles = (R + TILE - 1) / TILE;
  const long long blocks = (long long)rows * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem =
      (size_t)max_ops * OPW * sizeof(long long) + (size_t)max_code * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  program_kernel<<<(unsigned)blocks, THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      blob, G, NOP, mask, R, n_tiles, max_ops);
  return cudaGetLastError();
}
