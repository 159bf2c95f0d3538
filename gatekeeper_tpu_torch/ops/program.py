"""Every violation-program group of one evaluation, ANDed into the match
mask in place:

    mask[start + c, r] &= program(c, r)   for each group [start, start + B)

A group is its program's bytecode (ops/progcode.py) with the operands
bound to this evaluation's tensors by ``bind_group``.  ``program_eval``
launches the hand-written CUDA kernel K9 (kernels/program.cu) once for
all groups on a CUDA mask, and runs ``program_eval_plain`` on a CPU one.
``program_eval_plain`` executes the same bytecode instruction by
instruction over [B, R] tensors, group by group: the port's counterpart
of gatekeeper_tpu/ops/vexpr.py ``eval_program``, and the version K9 is
held against.  ``vexpr.eval_program`` computes the same masks from the IR
directly; the tests hold the two together.

A review passes ``pack=(autoreject, out)``: the candidate mask and the
autoreject mask leave the card bit-packed (ops/packbits.py's layout, as
gatekeeper_tpu/ops/driver.py _packed_variant packs them inside the
review's one jitted dispatch), and K9 packs them into ``out`` in its own
launch, so the review launches no K10.  Where no group has rows K9 is not
launched, and past PACK_IN_K9_MAX_ROWS rows the fold costs more than
K10's own launch: K10 packs in both cases.

A delta sweep passes ``delta=(resident, idx, out)``: the incremental
audit's int8 [C, 2w] before | after columns of the w evaluated rows
(ops/delta.py's function, gatekeeper_tpu/ops/driver.py _delta_fn's
gather and concatenation, which run in the same jitted dispatch as the
evaluation), written by K9 in its own launch, so the delta sweep launches
no K5.  Where no group has rows, or past DELTA_IN_K9_MAX_ROWS rows, K5
writes them after K9.  A launch packs a review or writes a delta, never
both.

A bound group is a plain dict (``start``, ``B``, ``code``, ``stack``,
``operands``), each operand a dict of its kind and tensors, so a run can
record and copy a call like any tensor tree.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import device as _dev
from . import delta as _delta
from . import packbits as _packbits
from . import progcode as pc
from .columns import T_FALSE, T_NUM, T_STR, T_UNDEF
from .interning import Interner
from .joinkernel import UNKNOWN_KEY
from .setcount import setcount_plain
from .vexpr import (EvalEnv, _cmp_values, _slot_mask, fill_join_counts,
                    join_counts)

# operand kinds, as kernels/program.cu reads them
SCALAR, SLOT, PARAM, ELEM, LITSTR, CONSTV = 0, 1, 2, 3, 4, 5
MASK_S, MASK_P, TABLE, SETCOUNT, JOIN = 6, 7, 8, 9, 10
_CMP_NAMES = {v: k for k, v in pc.CMP_OPS.items()}
# the opcodes that push one value and read nothing off the stack
PUSHES = (pc.CONST, pc.TRUTHY, pc.CMP, pc.STRPRED, pc.SETCOUNT, pc.JOIN)


def _value(d, kind):
    return {"kind": kind, "tcode": d["tcode"].contiguous(),
            "sid": d["sid"].contiguous(), "num": d["num"].contiguous()}


def _need(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def bind_group(enc: pc.Encoded, env: EvalEnv, start: int) -> dict:
    """The encoded program's operands resolved against ``env`` -> a bound
    group for rows [start, start + env.C) of the mask.  Join counts (K8)
    are computed here, once per (plan, exclude_self) for all groups that
    share ``env.joins.cache``."""
    ops: List[dict] = []
    for desc in enc.operands:
        kind = desc[0]
        if kind == "col":
            _k, colkey, slot, _s = desc
            op = _value(env.cols[colkey], SLOT if slot else SCALAR)
            op["width"] = op["sid"].shape[1] if slot else 0
        elif kind == "param":
            op = _value(env.params[desc[1]], PARAM)
        elif kind == "elem":
            _k, ppath, sub, _p = desc
            op = _value(env.elems[(ppath, sub)], ELEM)
            op["width"] = op["sid"].shape[1]
        elif kind == "litstr":
            d = env.params[("__lit__", desc[1])]
            op = {"kind": LITSTR, "tcode": d["tcode"].contiguous(),
                  "sid": d["sid"].contiguous()}
        elif kind == "const":
            _k, t, s, num = desc
            op = {"kind": CONSTV, "t": int(t), "s": int(s), "n": float(num)}
        elif kind == "slotmask":
            m = _slot_mask(env, desc[1]).contiguous()
            op = {"kind": MASK_S, "mask": m, "width": m.shape[1]}
        elif kind == "pmask":
            m = env.elems[(desc[1], ())]["mask"].contiguous()
            op = {"kind": MASK_P, "mask": m, "width": m.shape[1]}
        elif kind == "table":
            _k, pred_id, p_loop = desc
            tableT, idx = env.tables[pred_id]
            if idx.dim() == 2 and p_loop < 0:
                raise ValueError("per-element StrPred outside AnyParam")
            op = {"kind": TABLE, "table": tableT.contiguous(),
                  "idx": idx.contiguous(),
                  "width": idx.shape[1] if idx.dim() == 2 else 0}
        elif kind == "setcount":
            _k, ckey, kkey, orient, sop, n = desc
            op = {"kind": SETCOUNT,
                  "cids": env.elems[ckey]["sid"].contiguous(),
                  "cmask": env.elems[ckey]["mask"].contiguous(),
                  "kids": env.keysets[kkey].contiguous(),
                  "orient": orient, "op": sop, "n": int(n),
                  "pad": Interner.PAD}
        elif kind == "join":
            _k, plan_id, exclude_self, s_loop = desc
            if env.joins is None:
                op = {"kind": JOIN, "bound": 0, "width": 0}
            else:
                plan = env.joins.plans[plan_id]
                if plan.local_slot and s_loop < 0:
                    raise ValueError("slot column outside slot context")
                q = env.cols[plan.local_colkey]["sid"].contiguous()
                op = {"kind": JOIN, "bound": 1, "q": q,
                      "counts": join_counts(env, plan_id,
                                            exclude_self).contiguous(),
                      "width": q.shape[1] if plan.local_slot else 0}
        else:
            raise TypeError(desc)
        ops.append(op)
    # the widths an enclosing loop indexes by: a slot column or key must
    # span the loop's slots, a parameter element its elements
    for desc, op in zip(enc.operands, ops):
        loop = desc[-1] if desc[0] in ("col", "elem", "table", "join") \
            else -1
        if loop < 0 or not op.get("width"):
            continue
        width = ops[loop]["width"]
        if desc[0] in ("col", "join"):
            _need(op["width"] == width,
                  f"slot operand {desc[1]!r} spans {op['width']} slots, "
                  f"its loop {width}")
        else:
            _need(op["width"] >= width,
                  f"element operand {desc[1]!r} spans {op['width']} "
                  f"elements, its loop {width}")
    return {"start": int(start), "B": int(env.C), "code": enc.code,
            "stack": enc.stack, "operands": ops}


def lookup_joins(staged) -> None:
    """Every join lookup that the encoded programs of one evaluation
    name, ``staged`` its (enc, env) pairs, into their bindings' caches
    (vexpr.fill_join_counts: the table-mode ones in one K8 launch), before
    ``bind_group`` reads them."""
    fill_join_counts([(env, d[1], d[2]) for enc, env in staged
                      if env.joins is not None
                      for d in enc.operands if d[0] == "join"])


# ---- the plain version ------------------------------------------------------


class _Plain:
    """One group's bytecode over [B, R] tensors: the kernel's cell loop
    with every cell at once.  Jumps are skipped (every cell runs every
    instruction; the functions are pure, so the values are the same),
    except that ``ops``, when asked for, counts the instructions the
    kernel executes: a cell runs from the first instruction where its
    match bit is set, takes its jumps and leaves a loop once it holds."""

    def __init__(self, group: dict, R: int, device, reach=None):
        self.ops_ = group["operands"]
        self.B, self.R = group["B"], R
        self.device = device
        self.p = self.s = 0
        self.reach = reach
        self.ops = 0

    def const(self, v, dtype):
        return torch.tensor(v, dtype=dtype, device=self.device)

    def cmp(self, a, b, op: int, unk: bool):
        """OPA's order over (tcode, sid, num) triples: vexpr._cmp_values,
        ``self`` standing in for its env's constants."""
        keys = ("tcode", "sid", "num")
        return _cmp_values(dict(zip(keys, a)), dict(zip(keys, b)),
                           _CMP_NAMES[op], unk, self)

    def value(self, i: int):
        o = self.ops_[i]
        k = o["kind"]
        if k == CONSTV:
            return (self.const(o["t"], torch.int8),
                    self.const(o["s"], torch.int32),
                    self.const(o["n"], torch.float64))
        if k == LITSTR:
            return (o["tcode"][0], o["sid"][0],
                    self.const(0.0, torch.float64))
        arrs = (o["tcode"], o["sid"], o["num"])
        if k == SCALAR:
            return tuple(a[None] for a in arrs)
        if k == SLOT:
            return tuple(a[None, :, self.s] for a in arrs)
        if k == PARAM:
            return tuple(a[:, None] for a in arrs)
        if k == ELEM:
            return tuple(a[:, self.p][:, None] for a in arrs)
        raise TypeError(f"operand {i} of kind {k} is not a value")

    def mask_bit(self, i: int, idx: int):
        o = self.ops_[i]
        if o["kind"] == MASK_S:
            return o["mask"][None, :, idx]
        return o["mask"][:, idx][:, None]

    def strpred(self, a: int, t: int, negate: int):
        tcode, sid, _num = self.value(a)
        o = self.ops_[t]
        table, idx = o["table"], o["idx"]
        col = idx[:, self.p] if idx.dim() == 2 else idx
        sidc = sid.clamp(0, table.shape[0] - 1).long()
        hit = table[sidc, col.long()[:, None]] != 0
        res = (tcode == T_STR) & (sid >= 0) & hit
        return ~res if negate else res

    def setcount(self, i: int):
        o = self.ops_[i]
        return setcount_plain(o["cids"], o["cmask"], o["kids"], o["orient"],
                              o["op"], o["n"], o["pad"])

    def join(self, i: int, op: int, unk: int, rhs: int):
        o = self.ops_[i]
        if not o["bound"]:
            return self.const(bool(unk), torch.bool)
        q, counts = o["q"], o["counts"]
        if o["width"]:
            q, counts = q[None, :, self.s], counts[None, :, self.s]
        else:
            q, counts = q[None], counts[None]
        lhs = (torch.where(q >= 0, self.const(T_NUM, torch.int8),
                           self.const(T_UNDEF, torch.int8)),
               self.const(-1, torch.int32), counts.to(torch.float64))
        res = self.cmp(lhs, self.value(rhs), op, bool(unk))
        return torch.where(q == UNKNOWN_KEY,
                           self.const(bool(unk), torch.bool), res)

    def pushed(self, ins):
        """The value a pushing instruction (PUSHES) pushes at the current
        loop indices, broadcastable to [B, R]."""
        op = ins[0]
        if op == pc.CONST:
            return self.const(bool(ins[1]), torch.bool)
        if op == pc.TRUTHY:
            t = self.value(ins[1])[0]
            v = (t != T_UNDEF) & (t != T_FALSE)
            return ~v if ins[2] else v
        if op == pc.CMP:
            return self.cmp(self.value(ins[3]), self.value(ins[4]), ins[1],
                            bool(ins[2]))
        if op == pc.STRPRED:
            return self.strpred(ins[1], ins[2], ins[3])
        if op == pc.SETCOUNT:
            return self.setcount(ins[1])
        return self.join(ins[1], ins[2], ins[3], ins[4])

    def cost(self, ins) -> int:
        if ins[0] == pc.SETCOUNT:
            o = self.ops_[ins[1]]
            return 1 + 2 * o["cids"].shape[1] * o["kids"].shape[1]
        return 1

    def count(self, ins):
        self.ops += int(self.reach.sum()) * self.cost(ins)

    def full(self, x):
        return x.expand(self.B, self.R)

    def run(self, code: np.ndarray):
        code = code.reshape(-1, pc.WIDTH).tolist()
        stack: list = []
        # per loop depth: the index the loop hides, and the cells that
        # entered it (for the count)
        saved = [0] * pc.MAX_LOOPS
        entry: list = [None] * pc.MAX_LOOPS
        pending: dict = {}
        counting = self.reach is not None
        at = 0
        while True:
            ins = code[at]
            op = ins[0]
            if counting:
                if at in pending:
                    self.reach = self.reach | pending.pop(at)
                self.count(ins)
            at += 1
            if op in PUSHES:
                stack.append(self.pushed(ins))
            elif op in (pc.AND, pc.OR):
                y, x = stack.pop(), stack.pop()
                stack.append(x & y if op == pc.AND else x | y)
            elif op == pc.NOT:
                stack.append(~stack.pop())
            elif op in (pc.JFALSE, pc.JTRUE):
                if counting:
                    top = self.full(stack[-1])
                    leave = self.reach & (top if op == pc.JTRUE else ~top)
                    pending[ins[1]] = pending.get(ins[1], leave) | leave
                    self.reach = self.reach & ~leave
            elif op == pc.LOOP:
                axis, m, end, depth = ins[1:5]
                stack.append(self.const(False, torch.bool))
                if self.ops_[m]["width"] == 0:
                    at = end
                    continue
                saved[depth] = self._get(axis)
                entry[depth] = self.reach
                self._set(axis, 0)
                stack.append(self.mask_bit(m, 0))
            elif op == pc.ENDLOOP:
                axis, m, body, depth = ins[1:5]
                part = stack.pop()
                acc = stack.pop() | part
                idx = self._get(axis) + 1
                stack.append(acc)
                if idx < self.ops_[m]["width"]:
                    self._set(axis, idx)
                    stack.append(self.mask_bit(m, idx))
                    if counting:
                        self.reach = entry[depth] & ~self.full(acc)
                    at = body
                else:
                    self._set(axis, saved[depth])
                    if counting:
                        self.reach = entry[depth]
            elif op == pc.HALT:
                (out,) = stack
                return out
            else:
                raise ValueError(f"bad opcode {op}")

    def _get(self, axis: int) -> int:
        return self.p if axis == pc.AXIS_P else self.s

    def _set(self, axis: int, idx: int):
        if axis == pc.AXIS_P:
            self.p = idx
        else:
            self.s = idx


def program_eval_plain(mask: torch.Tensor, groups: List[dict],
                       ops: Optional[list] = None) -> torch.Tensor:
    """The bytecode over [B, R] tensors, group by group, ANDed into
    ``mask`` in place.  With ``ops`` (a list) given, appends each group's
    count of the instructions the kernel executes on these inputs."""
    R = mask.shape[1]
    for g in groups:
        rows = mask[g["start"]:g["start"] + g["B"]]
        reach = rows.clone() if ops is not None else None
        ex = _Plain(g, R, mask.device, reach)
        rows &= ex.run(g["code"])
        if ops is not None:
            ops.append(ex.ops)
    return mask


# ---- the kernel ----------------------------------------------------------------


def _i64(x: float) -> int:
    return int(np.array([x], np.float64).view(np.int64)[0])


def _operand_words(o: dict, dev) -> list:
    """One operand's row of the launch's table, after checking its
    tensors."""
    k = o["kind"]
    w = [k, 0, 0, 0, 0, 0, 0, 0]
    if k in (SCALAR, SLOT, PARAM, ELEM):
        nd = 2 if k in (SLOT, ELEM) else 1
        _dev.check(o["tcode"], "tcode", torch.int8, nd, dev)
        _dev.check(o["sid"], "sid", torch.int32, nd, dev)
        _dev.check(o["num"], "num", torch.float64, nd, dev)
        w[1:5] = [_dev.ptr(o["tcode"]), _dev.ptr(o["sid"]),
                  _dev.ptr(o["num"]), o.get("width", 0)]
    elif k == LITSTR:
        _dev.check(o["tcode"], "tcode", torch.int8, 1, dev)
        _dev.check(o["sid"], "sid", torch.int32, 1, dev)
        w[1:3] = [_dev.ptr(o["tcode"]), _dev.ptr(o["sid"])]
    elif k == CONSTV:
        w[5:8] = [o["t"], o["s"], _i64(o["n"])]
    elif k in (MASK_S, MASK_P):
        _dev.check(o["mask"], "mask", torch.bool, 2, dev)
        w[1], w[4] = _dev.ptr(o["mask"]), o["width"]
    elif k == TABLE:
        _dev.check(o["table"], "table", torch.uint8, 2, dev)
        if o["idx"].dim() not in (1, 2):
            raise ValueError("table idx must be [B] or [B, P]")
        _dev.check(o["idx"], "idx", torch.int32, o["idx"].dim(), dev)
        V, U = o["table"].shape
        if V == 0 or U == 0:
            raise ValueError("empty predicate table")
        w[1:6] = [_dev.ptr(o["table"]), V, U, _dev.ptr(o["idx"]), o["width"]]
    elif k == SETCOUNT:
        _dev.check(o["cids"], "cids", torch.int32, 2, dev)
        _dev.check(o["cmask"], "cmask", torch.bool, 2, dev)
        _dev.check(o["kids"], "kids", torch.int32, 2, dev)
        if o["cmask"].shape != o["cids"].shape:
            raise ValueError("cmask must match cids")
        P, K = o["cids"].shape[1], o["kids"].shape[1]
        w[1:8] = [_dev.ptr(o["cids"]), _dev.ptr(o["cmask"]),
                  _dev.ptr(o["kids"]), P, K, o["orient"] + 16 * o["op"],
                  (o["pad"] << 32) | (o["n"] & 0xFFFFFFFF)]
    elif k == JOIN:
        if o["bound"]:
            nd = 2 if o["width"] else 1
            _dev.check(o["q"], "q", torch.int32, nd, dev)
            _dev.check(o["counts"], "counts", torch.int32, nd, dev)
            w[1:5] = [_dev.ptr(o["q"]), _dev.ptr(o["counts"]), o["width"], 1]
    else:
        raise TypeError(f"operand kind {k}")
    return w


def _check_rows(o: dict, g: dict, R: int):
    """An operand's leading axis must be the group's constraints (B) or
    the evaluation's rows (R): the kernel indexes it by c or r."""
    k = o["kind"]
    if k in (PARAM, ELEM, MASK_P):
        t = o["sid"] if k != MASK_P else o["mask"]
        _need(t.shape[0] == g["B"], f"operand rows {t.shape[0]} != B")
    elif k == TABLE:
        _need(o["idx"].shape[0] == g["B"], "table idx rows != B")
    elif k == SETCOUNT:
        _need(o["cids"].shape[0] == g["B"] and o["kids"].shape[0] == R,
              "set-count operands' rows differ from [B] x [R]")
    elif k in (SCALAR, SLOT, MASK_S):
        t = o["sid"] if k != MASK_S else o["mask"]
        _need(t.shape[0] == R, f"column rows {t.shape[0]} != R {R}")
    elif k == JOIN and o["bound"]:
        _need(o["q"].shape == o["counts"].shape and o["q"].shape[0] == R,
              "join counts differ from their key column")
    elif k == LITSTR:
        _need(o["sid"].numel() >= 1, "empty literal")


# K9's geometry (kernels/program.cu): rows a thread's item, threads a
# block, and items a thread walks at most
ROWS_PER_THREAD = 8
THREADS = 256
ITEMS = 8


def items_per_row(R: int) -> int:
    """K9's items for one constraint row of R rows: V consecutive rows
    each, or where R >= 32 V a warp's 32 V rows over 32 threads (lane i of
    thread t on row 32 i + t), V = ROWS_PER_THREAD."""
    V = ROWS_PER_THREAD
    if R >= 32 * V:
        return -(-R // (32 * V)) * 32
    return -(-R // V)


def group_blocks(B: int, R: int) -> int:
    """K9's blocks for a group of B constraint rows: up to ITEMS items a
    thread, THREADS threads a block, no block shared by two groups."""
    items = B * items_per_row(R)
    if items >= 2 ** 31:
        raise ValueError(f"a group of {B} rows x {R} is past K9's 2^31 items")
    return -(-items // (THREADS * ITEMS))


def rows_of_no_group(groups: List[dict], C: int) -> List[tuple]:
    """The (begin, end) ranges of the rows of a [C, R] mask that no group
    of B > 0 covers, in order."""
    covered = np.zeros(C + 1, bool)
    for g in groups:
        covered[g["start"]:g["start"] + g["B"]] = True
    covered[C] = True
    edges = np.flatnonzero(np.diff(np.concatenate([[True], covered])))
    return [(int(b), int(e)) for b, e in zip(edges[::2], edges[1::2])]


def pack_launch(groups: List[dict], C: int, R: int, dev) -> dict:
    """The launch of K9 for the groups over a [C, R] mask, checked: one
    int64 blob of G headers (mask row start, B, the group's first block,
    code offset and length in int32 words, operand offset and count,
    stack depth), then the operands (OPW words each, pointers of tensors
    on ``dev``), then every group's code, padded to whole words, then U
    and U (begin, end) ranges of the mask rows no group covers, which a
    review's launch packs from memory (program.cu pack_rows_of_no_group);
    with the counts the launcher takes.  Groups with B = 0 are dropped."""
    groups = [g for g in groups if g["B"] > 0]
    headers, table, code = [], [], []
    blocks = code_words = 0
    for g in groups:
        if g["start"] < 0 or g["start"] + g["B"] > C:
            raise ValueError(f"group rows [{g['start']}, "
                             f"{g['start'] + g['B']}) outside the mask's {C}")
        if g["stack"] > pc.MAX_STACK:
            raise ValueError(f"group stack {g['stack']} > {pc.MAX_STACK}")
        n_code = len(g["code"])
        headers.append([g["start"], g["B"], blocks, code_words, n_code,
                        len(table), len(g["operands"]), g["stack"]])
        for o in g["operands"]:
            _check_rows(o, g, R)
            table.append(_operand_words(o, dev))
        code.append(np.asarray(g["code"], np.int32))
        blocks += group_blocks(g["B"], R)
        code_words += n_code
    code = np.concatenate(code) if code else np.zeros(0, np.int32)
    if len(code) % 2:
        code = np.append(code, np.int32(0))
    free = rows_of_no_group(groups, C)
    blob = np.concatenate([
        np.asarray(headers, np.int64).reshape(-1),
        np.asarray(table, np.int64).reshape(-1),
        code.view(np.int64),
        np.asarray([len(free)] + [x for r in free for x in r], np.int64),
    ])
    return {"blob": blob, "G": len(headers), "NOP": len(table),
            "blocks": blocks,
            "max_code": max((h[4] for h in headers), default=0),
            "max_ops": max((h[6] for h in headers), default=0)}


# The largest review row count R whose pack K9 runs in its own launch;
# past it K9 runs alone and K10 packs.  Times of the review's device chain
# on one NVIDIA H100 80GB HBM3 (700.00 W), 500 templates (C = 1024), ms,
# the fused launch against K9 then K10 on the same inputs, each in two
# turns (tools/kernel_turns.py --kernels review_chain; PERF.md): R = 8
# 0.0248-0.0282 / 0.0293-0.0297; 16 0.0376-0.0377 / 0.0313-0.0387;
# 32 0.0541-0.0544 / 0.0545-0.0552; 64 0.0756-0.0757 / 0.0745-0.0746;
# 256 0.1218 / 0.1165-0.1168.  Each item's thread packs its own
# rows, so the fold's work grows with the items a thread walks, while
# K10's launch costs the same at every R.
PACK_IN_K9_MAX_ROWS = 32


# The largest delta row count w whose before | after columns K9 writes in
# its own launch; past it K9 runs alone and K5 writes them.  Times of the
# delta sweep's program step on one NVIDIA H100 80GB HBM3 (700.00 W), 500
# templates (C = 1024), ms, the fused launch against K9 then K5 on the
# same inputs, in two turns (tools/kernel_turns.py --kernels delta_chain;
# PERF.md): w = 8 0.0280 / 0.0303 (once 0.0230); 16 0.0372 / 0.0398-0.0399;
# 64 0.0724-0.0725 / 0.0745-0.0748; 128 0.1253-0.1259 / 0.1277-0.1280;
# 256 0.1232-0.1234 / 0.1190-0.1194.
DELTA_IN_K9_MAX_ROWS = 128

# blocks a delta launch gives its gather at most (two a SM of the H100);
# their threads stride past them
GATHER_BLOCKS_MAX = 264


def gather_blocks(C: int, R: int) -> int:
    """The blocks after the groups' that gather a delta launch's
    before-bytes (and write the rows of no group) over a [C, R] mask: a
    thread a unit of ROWS_PER_THREAD columns of a row, at most
    GATHER_BLOCKS_MAX."""
    units = C * -(-R // ROWS_PER_THREAD)
    return min(-(-units // THREADS), GATHER_BLOCKS_MAX)


def _check_delta(delta, mask: torch.Tensor):
    resident, idx, out = delta
    dev = mask.device
    C, R = mask.shape
    _dev.check(resident, "resident", torch.bool, 2, dev)
    _dev.check(idx, "idx", torch.int32, 1, dev)
    _dev.check(out, "out", torch.int8, 2, dev)
    if resident.shape[0] != C:
        raise ValueError(f"resident rows {resident.shape[0]} != mask rows "
                         f"{C}")
    if idx.shape[0] != R:
        raise ValueError(f"idx {tuple(idx.shape)} != the mask's {R} rows")
    if tuple(out.shape) != (C, 2 * R):
        raise ValueError(f"out {tuple(out.shape)} != {(C, 2 * R)}")
    return resident, idx, out


def _check_pack(pack, mask: torch.Tensor):
    autoreject, out = pack
    dev = mask.device
    C, R = mask.shape
    _dev.check(autoreject, "autoreject", torch.bool, 2, dev)
    _dev.check(out, "out", torch.uint8, 2, dev)
    if autoreject.shape != mask.shape:
        raise ValueError(f"autoreject {tuple(autoreject.shape)} != mask "
                         f"{tuple(mask.shape)}")
    if tuple(out.shape) != (2 * C, -(-R // 8)):
        raise ValueError(f"out {tuple(out.shape)} != {(2 * C, -(-R // 8))}")
    return autoreject, out


def _check_modes(mask, pack, delta):
    if pack is not None and delta is not None:
        raise ValueError("a launch packs a review or writes a delta sweep's "
                         "columns, not both")
    return (None if pack is None else _check_pack(pack, mask),
            None if delta is None else _check_delta(delta, mask))


def program_eval_cuda(mask: torch.Tensor, groups: List[dict],
                      pack=None, delta=None) -> torch.Tensor:
    """K9: one launch for every group.  With ``pack=(autoreject, out)``
    the same launch packs ``mask`` (after the groups) and ``autoreject``
    into ``out``; K10 packs instead where K9 is not launched (no group
    has rows) or R is past PACK_IN_K9_MAX_ROWS.  With ``delta=(resident,
    idx, out)`` (idx int32 in [0, resident's columns): ops/delta.py
    delta_index checks it) the same launch writes out[:, :R] =
    resident[:, idx] and out[:, R:] = ``mask`` after the groups; K5
    writes them instead where K9 is not launched or R is past
    DELTA_IN_K9_MAX_ROWS."""
    dev = mask.device
    _dev.check(mask, "mask", torch.bool, 2, dev)
    pack, delta = _check_modes(mask, pack, delta)
    C, R = mask.shape
    if R == 0:
        return mask
    lp = pack_launch(groups, C, R, dev)
    fold = pack is not None and lp["G"] > 0 and R <= PACK_IN_K9_MAX_ROWS
    fold_delta = delta is not None and lp["G"] > 0 and \
        R <= DELTA_IN_K9_MAX_ROWS
    if lp["G"]:
        # a fresh device buffer every evaluation (the table holds this
        # evaluation's pointers, and the counter starts at 0), copied from
        # pinned memory without waiting: the launch queues behind the
        # copy, and the caching host allocator keeps the pinned block until
        # the copy is done
        blob_d = _dev.upload(lp["blob"], dev)
        autoreject, out = pack if fold else (None, None)
        resident, idx, dout = delta if fold_delta else (None, None, None)
        extra = gather_blocks(C, R) if fold_delta else 0
        _dev.launch(
            "program_pack" if fold else
            "program_delta" if fold_delta else "program", dev,
            _dev.ptr(blob_d), lp["G"], lp["NOP"], _dev.ptr(mask), R,
            lp["blocks"], lp["max_code"], lp["max_ops"],
            _dev.ptr(autoreject) if fold else None,
            _dev.ptr(out) if fold else None,
            C if fold or fold_delta else 0,
            _dev.ptr(resident) if fold_delta else None,
            resident.shape[1] if fold_delta else 0,
            _dev.ptr(idx) if fold_delta else None,
            _dev.ptr(dout) if fold_delta else None, extra,
            _dev.stream(mask),
        )
    if pack is not None and not fold:
        _packbits.pack_review_masks_cuda(mask, pack[0], out=pack[1])
    if delta is not None and not fold_delta:
        _delta.delta_columns_cuda(delta[0], delta[1], mask, out=delta[2])
    return mask


def program_eval(mask: torch.Tensor, groups: List[dict],
                 pack=None, delta=None) -> torch.Tensor:
    """K9 on a CUDA mask, the plain version on a CPU one; ``pack`` and
    ``delta`` as in program_eval_cuda (on the CPU, the plain pack or the
    plain delta columns after the groups)."""
    if mask.device.type == "cpu":
        pack, delta = _check_modes(mask, pack, delta)
        program_eval_plain(mask, groups)
        if pack is not None:
            autoreject, out = pack
            out.copy_(_packbits.pack_review_masks_plain(mask, autoreject))
        if delta is not None:
            resident, idx, out = delta
            out.copy_(_delta.delta_columns_plain(resident, idx, mask))
        return mask
    return program_eval_cuda(mask, groups, pack, delta)
