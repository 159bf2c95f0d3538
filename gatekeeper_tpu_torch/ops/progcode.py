"""The violation program as data: a bytecode for kernel K9.

``encode(prog)`` lowers a VProgram (ops/vexpr.py) to an ``Encoded``:

- ``code``: a flat int32 instruction stream, ``WIDTH`` words an
  instruction (an opcode and up to five arguments), jump targets counted
  in instructions;
- ``operands``: the symbolic operands the stream names by index (columns,
  parameters, parameter elements, literals, slot and element masks,
  predicate tables, set counts, join counts), each bound to this
  evaluation's tensors by ops/program.py ``bind_group``;
- ``stack``: the depth of the boolean stack the stream needs, and
  ``loops`` the depth of its loop nesting.

The stream is cached on ``structure_key()``: template clones share one.
The operand table is rebuilt for every evaluation, because the delta path
binds fresh w-row slices each time.

One cell (c, r) runs the stream on a stack of booleans.  Clauses are ORed
and their conditions ANDed, with jumps that skip the rest of a clause
whose value is decided (JFALSE) and the rest of the program once a clause
holds (JTRUE): the functions are pure, so the value is the one
``vexpr.eval_program`` computes.  AnyParam, a slot clause and ReduceSlots
are loops over an axis (P or S) of a mask operand: LOOP pushes the
accumulator (False) and the first element's mask bit, the body ANDs its
conditions into that bit, and ENDLOOP ORs it into the accumulator and
either starts the next element or, once the accumulator holds or the
axis ends, leaves the accumulator.  LOOP and ENDLOOP both carry the
loop's axis, mask operand and nesting depth, and ENDLOOP its body's first
instruction, so an executor keeps no frame of its own: the index an inner
loop of the same axis hides is saved per depth.

The encoder refuses what ``eval_program`` refuses, with the same
ValueErrors: AnySlots anywhere, a nested slot reduction, slot conditions
without ``slot_iter``, a slot column outside a slot context, a parameter
element outside AnyParam, an unsupported literal or SetCountCmp; and it
raises on a stream past the kernel's fixed bounds (``MAX_STACK``,
``MAX_LOOPS``, ``MAX_INSTRS``, ``MAX_OPERANDS``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .columns import T_FALSE, T_NUM, T_TRUE
from .vexpr import (
    AnyParam,
    AnySlots,
    BoolOp,
    Cmp,
    ColRef,
    Const,
    JoinCmp,
    Lit,
    ParamElemRef,
    ParamRef,
    ReduceSlots,
    SetCountCmp,
    StrPred,
    Truthy,
    VProgram,
    _SETCOUNT_OPS,
    _clause_uses_slot,
)

# the kernel's fixed bounds (kernels/program.cu has the same numbers)
WIDTH = 6          # int32 words an instruction
MAX_STACK = 32     # booleans on the stack: the bits of one 32-bit word
MAX_LOOPS = 4      # nested loops
MAX_INSTRS = 1024  # instructions a group
MAX_OPERANDS = 256  # operands a group

# opcodes; the arguments of each follow it in its WIDTH-word slot
CONST = 0     # value                          push value
TRUTHY = 1    # operand, negate                push truthy(operand) ^ negate
CMP = 2       # op, unknown, lhs, rhs          push lhs <op> rhs
STRPRED = 3   # operand, table, negate         push the table's hit ^ negate
SETCOUNT = 4  # operand                        push count(left - right) <op> n
JOIN = 5      # operand, op, unknown, rhs      push count at the key <op> rhs
AND = 6       #                                pop y, pop x, push x & y
OR = 7        #                                pop y, pop x, push x | y
NOT = 8       #                                top = !top
JFALSE = 9    # target                         top false: go to target
JTRUE = 10    # target                         top true: go to target
LOOP = 11     # axis, mask, end, depth         push False, push mask[0]
ENDLOOP = 12  # axis, mask, body, depth        part = pop, acc = pop | part
HALT = 13     #                                the cell's value is the top

# the boolean stack's change for each opcode
_STACK_DELTA = {
    CONST: 1, TRUTHY: 1, CMP: 1, STRPRED: 1, SETCOUNT: 1, JOIN: 1, AND: -1,
    OR: -1, NOT: 0, JFALSE: 0, JTRUE: 0, LOOP: 2, ENDLOOP: -1, HALT: 0,
}

AXIS_P, AXIS_S = 0, 1
CMP_OPS = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}


@dataclass(frozen=True)
class Encoded:
    code: np.ndarray  # int32 [n_instr * WIDTH]
    operands: Tuple[Tuple, ...]
    stack: int
    loops: int

    @property
    def n_instr(self) -> int:
        return len(self.code) // WIDTH


# Symbolic operands.  The last field of those that need it is the index of
# the enclosing loop's mask operand (-1 for none): ops/program.py checks
# the bound widths against it.
#   ("col", colkey, slot, s_loop)      a scalar [R] or slot [R, S] column
#   ("param", ppath)                   a per-constraint scalar [C]
#   ("elem", ppath, subpath, p_loop)   an element of a parameter array [C, P]
#   ("litstr", value)                  a string literal, interned [1]
#   ("const", tcode, sid, num)         a bool or number literal
#   ("slotmask", iter_key)             the iteration group's slot mask [R, S]
#   ("pmask", ppath)                   a parameter array's mask [C, P]
#   ("table", pred_id, p_loop)         predicate tables and their columns
#   ("setcount", cside, kside, orient, op, n)
#   ("join", plan_id, exclude_self, s_loop)


class _Encoder:
    def __init__(self, prog: VProgram):
        self.prog = prog
        self.code: List[List[int]] = []
        self.operands: Dict[Tuple, int] = {}
        self.depth = self.max_depth = 0
        self.loop_depth = self.max_loops = 0

    def emit(self, op: int, *args: int) -> int:
        self.code.append([op, *args] + [0] * (WIDTH - 1 - len(args)))
        self.depth += _STACK_DELTA[op]
        self.max_depth = max(self.max_depth, self.depth)
        return len(self.code) - 1

    def patch(self, at: int, field: int, target: int):
        self.code[at][1 + field] = target

    def operand(self, desc: Tuple) -> int:
        idx = self.operands.get(desc)
        if idx is None:
            idx = self.operands[desc] = len(self.operands)
        return idx

    # ---- operands ----------------------------------------------------------

    def value(self, op, s_loop: int, p_loop: int) -> int:
        if isinstance(op, ColRef):
            if op.slot and s_loop < 0:
                raise ValueError("slot column outside slot context")
            return self.operand(("col", op.colkey, op.slot,
                                 s_loop if op.slot else -1))
        if isinstance(op, ParamRef):
            return self.operand(("param", op.ppath))
        if isinstance(op, ParamElemRef):
            if p_loop < 0:
                raise ValueError("ParamElemRef outside AnyParam")
            return self.operand(("elem", op.ppath, op.subpath, p_loop))
        if isinstance(op, Lit):
            v = op.value
            if isinstance(v, str):
                return self.operand(("litstr", v))
            if isinstance(v, bool):
                return self.operand(
                    ("const", T_TRUE if v else T_FALSE, -1, 0.0))
            if isinstance(v, (int, float)):
                return self.operand(("const", T_NUM, -1, float(v)))
            raise ValueError(f"unsupported literal {v!r}")
        raise TypeError(op)

    # ---- nodes -------------------------------------------------------------

    def node(self, node, s_loop: int, p_loop: int):
        if isinstance(node, Const):
            self.emit(CONST, int(bool(node.value)))
        elif isinstance(node, Truthy):
            self.emit(TRUTHY, self.value(node.operand, s_loop, p_loop),
                      int(node.negate))
        elif isinstance(node, Cmp):
            a = self.value(node.lhs, s_loop, p_loop)
            b = self.value(node.rhs, s_loop, p_loop)
            self.emit(CMP, CMP_OPS[node.op], int(bool(node.unknown_default)),
                      a, b)
        elif isinstance(node, StrPred):
            a = self.value(node.operand, s_loop, p_loop)
            t = self.operand(("table", node.pred_id, p_loop))
            self.emit(STRPRED, a, t, int(node.negate))
        elif isinstance(node, AnyParam):
            m = self.operand(("pmask", node.ppath))
            self.loop(AXIS_P, m, node.inner, s_loop, m)
        elif isinstance(node, SetCountCmp):
            self.emit(SETCOUNT, self.operand(self.setcount(node)))
        elif isinstance(node, JoinCmp):
            j = self.operand(("join", node.plan_id, bool(node.exclude_self),
                              s_loop))
            b = self.value(node.rhs, s_loop, p_loop)
            self.emit(JOIN, j, CMP_OPS[node.op],
                      int(bool(node.unknown_default)), b)
        elif isinstance(node, BoolOp):
            self.boolop(node, s_loop, p_loop)
        elif isinstance(node, ReduceSlots):
            if s_loop >= 0:
                raise ValueError("nested slot reduction is not supported")
            m = self.operand(("slotmask", node.iter_key))
            self.loop(AXIS_S, m, node.inner, m, p_loop)
        elif isinstance(node, AnySlots):
            raise ValueError("AnySlots must be handled at clause level")
        else:
            raise TypeError(node)

    def setcount(self, node: SetCountCmp) -> Tuple:
        sides = []
        for kind, key in (node.left, node.right):
            sides.append(("R", key) if kind == "keyset" else ("C", key))
        (lax, lkey), (rax, rkey) = sides
        if lax == "C" and rax == "R":
            return ("setcount", lkey, rkey, 0, _SETCOUNT_OPS[node.op], node.n)
        if lax == "R" and rax == "C":
            return ("setcount", rkey, lkey, 1, _SETCOUNT_OPS[node.op], node.n)
        raise ValueError("unsupported SetCountCmp side combination")

    def boolop(self, node: BoolOp, s_loop: int, p_loop: int):
        if node.op == "not":
            self.node(node.children[0], s_loop, p_loop)
            self.emit(NOT)
            # the later children are evaluated and dropped by
            # eval_program: encode them aside for its refusals only
            for child in node.children[1:]:
                _Encoder(self.prog).node(child, s_loop, p_loop)
            return
        jump, combine = (JFALSE, AND) if node.op == "and" else (JTRUE, OR)
        jumps = []
        for i, child in enumerate(node.children):
            if i:
                jumps.append(self.emit(jump, 0))
            self.node(child, s_loop, p_loop)
            if i:
                self.emit(combine)
        for at in jumps:
            self.patch(at, 0, len(self.code))

    def loop(self, axis: int, mask: int, conds, s_loop: int, p_loop: int):
        """any over the axis of (mask & AND conds)."""
        depth = self.loop_depth
        self.loop_depth += 1
        self.max_loops = max(self.max_loops, self.loop_depth)
        start = self.emit(LOOP, axis, mask, 0, depth)
        jumps = []
        for cond in conds:
            jumps.append(self.emit(JFALSE, 0))
            self.node(cond, s_loop, p_loop)
            self.emit(AND)
        end = self.emit(ENDLOOP, axis, mask, start + 1, depth)
        for at in jumps:
            self.patch(at, 0, end)
        self.patch(start, 2, end + 1)
        self.loop_depth -= 1

    def clause(self, clause):
        r_conds = [c for c in clause.conds if not _clause_uses_slot(c)]
        s_conds = [c for c in clause.conds if _clause_uses_slot(c)]
        jumps = []
        for i, cond in enumerate(r_conds):
            if i:
                jumps.append(self.emit(JFALSE, 0))
            self.node(cond, -1, -1)
            if i:
                self.emit(AND)
        if clause.slot_iter is not None:
            if r_conds:
                jumps.append(self.emit(JFALSE, 0))
            m = self.operand(("slotmask", clause.slot_iter))
            self.loop(AXIS_S, m, s_conds, m, -1)
            if r_conds:
                self.emit(AND)
        elif s_conds:
            raise ValueError("slot conditions without slot_iter")
        elif not r_conds:
            self.emit(CONST, 1)
        for at in jumps:
            self.patch(at, 0, len(self.code))

    def program(self) -> Encoded:
        clauses = self.prog.clauses
        jumps = []
        for i, clause in enumerate(clauses):
            if i:
                jumps.append(self.emit(JTRUE, 0))
            self.clause(clause)
            if i:
                self.emit(OR)
        if not clauses:
            self.emit(CONST, 0)
        for at in jumps:
            self.patch(at, 0, len(self.code))
        self.emit(HALT)
        if self.depth != 1:
            raise AssertionError(f"stack ends at depth {self.depth}")
        if self.max_depth > MAX_STACK:
            raise ValueError(f"program needs a stack of {self.max_depth}, "
                             f"past the kernel's {MAX_STACK}")
        if self.max_loops > MAX_LOOPS:
            raise ValueError(f"program nests {self.max_loops} loops, past "
                             f"the kernel's {MAX_LOOPS}")
        if len(self.code) > MAX_INSTRS:
            raise ValueError(f"program has {len(self.code)} instructions, "
                             f"past the kernel's {MAX_INSTRS}")
        if len(self.operands) > MAX_OPERANDS:
            raise ValueError(f"program has {len(self.operands)} operands, "
                             f"past the kernel's {MAX_OPERANDS}")
        code = np.asarray(self.code, np.int32).reshape(-1)
        return Encoded(code, tuple(self.operands), self.max_depth,
                       self.max_loops)


_cache: Dict[str, Encoded] = {}
_CACHE_MAX = 4096


def encode(prog: VProgram) -> Encoded:
    """The program's bytecode, cached on its structure key."""
    key = prog.structure_key()
    enc = _cache.get(key)
    if enc is None:
        enc = _Encoder(prog).program()
        if len(_cache) >= _CACHE_MAX:
            _cache.clear()
        _cache[key] = enc
    return enc

