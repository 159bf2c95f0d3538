"""The violation programs as bytecode (gatekeeper_tpu_torch/ops/progcode.py)
and their plain executor (ops/program.py program_eval_plain, the version
kernel K9 is held against on the card), on the CPU.

- program_eval_plain over the encoded bytecode is bit-equal to the port's
  vexpr.eval_program and to the JAX package's eval_program on the JAX
  driver's packed groups: the synthetic corpus (6 structures), the render
  corpus, and the referential corpus in 'trace' and 'tables' join modes.
- Seeded single-node cases for every node kind, on random environments
  made from a seed with numpy.
- The encoder refuses what eval_program refuses, with the same
  ValueErrors, and every corpus program fits the kernel's bounds.
- TorchDriver evaluates through the bytecode, never through eval_program.
- K9's control rule on the CPU (``tiled_eval``): the bytecode run on tiles
  of T cells that share their jumps and loop exits, taken only where every
  live cell of the tile takes them, as the threads of one warp of K9 do,
  bit-equal to the plain executor and to eval_program for T = 1, 8, 32 and
  R; the executed-instruction count the kernel's bound is computed from is
  the one the bytecode had before LOOP and ENDLOOP carried their
  arguments; the launch packing (``pack_launch``) and its offsets.

Masks are booleans: every comparison is exact (tolerance 0).
"""

import copy
import pathlib

import numpy as np
import pytest
import torch

from gatekeeper_tpu.client import Client as JClient
from gatekeeper_tpu.engine.value import thaw
from gatekeeper_tpu.ops import joinkernel as jjk
from gatekeeper_tpu.ops import vexpr as jv
from gatekeeper_tpu.ops.columns import extract_columns
from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu.ops.pack import pack_reviews
from gatekeeper_tpu.util import synthetic as jsyn
from gatekeeper_tpu_torch import device as tdev
from gatekeeper_tpu_torch.client import Client as TClient
from gatekeeper_tpu_torch.client import InterpDriver as TInterp
from gatekeeper_tpu_torch.convert import (
    group_params_from_numpy,
    state_from_numpy,
    take_rows,
)
from gatekeeper_tpu_torch.ops import joinkernel as tjk
from gatekeeper_tpu_torch.ops import progcode
from gatekeeper_tpu_torch.ops import vexpr as tv
from gatekeeper_tpu_torch.ops import program as tprogram
from gatekeeper_tpu_torch.ops.program import (
    bind_group,
    program_eval,
    program_eval_plain,
)
from gatekeeper_tpu_torch.ops.vectorizer import vectorize as tvectorize
from gatekeeper_tpu_torch.util import synthetic as tsyn

from .render_corpus import corpus, join_corpus, resources


def bytecode_eval(prog, env):
    """The program's bytecode, bound to ``env``, on an all-True mask: the
    program's own [C, R] value."""
    mask = torch.ones((env.C, env.R), dtype=torch.bool)
    group = bind_group(progcode.encode(prog), env, 0)
    return program_eval_plain(mask, [group]).numpy()


def tiled_eval(mask, group, T):
    """K9's control rule on the CPU -> the group's rows of ``mask`` ANDed
    with the program (numpy [B, R]).  The group's cells, row-major, are cut
    into tiles of T, each run as one warp of K9 runs its threads' rows: one
    instruction stream for the tile, a jump taken only where every live
    cell of the tile takes it, a loop continued while any live cell's
    accumulator is False, LOOP and ENDLOOP read from their arguments.  A
    cell whose value is decided runs on through its clause or loop."""
    B, R = group["B"], mask.shape[1]
    ex = tprogram._Plain(group, R, mask.device)
    code = np.asarray(group["code"]).reshape(-1, progcode.WIDTH).tolist()
    memo = {}

    def full(key, make, idx):
        if (key, *idx) not in memo:
            ex.p, ex.s = idx
            memo[(key, *idx)] = make().expand(B, R).reshape(-1).numpy()
        return memo[(key, *idx)]

    live_all = mask[group["start"]:group["start"] + B].reshape(-1).numpy()
    out = np.zeros(B * R, bool)
    for t0 in range(0, B * R, T):
        cells = slice(t0, min(t0 + T, B * R))
        live = live_all[cells]
        if not live.any():
            continue
        stack, idx, saved, at = [], [0, 0], [0] * progcode.MAX_LOOPS, 0
        while True:
            ins = code[at]
            op, at = ins[0], at + 1
            if op in tprogram.PUSHES:
                stack.append(full(at - 1, lambda: ex.pushed(ins), idx)[cells])
            elif op in (progcode.AND, progcode.OR):
                y, x = stack.pop(), stack.pop()
                stack.append(x & y if op == progcode.AND else x | y)
            elif op == progcode.NOT:
                stack.append(~stack.pop())
            elif op == progcode.JFALSE:
                if not (stack[-1] & live).any():
                    at = ins[1]
            elif op == progcode.JTRUE:
                if (stack[-1] | ~live).all():
                    at = ins[1]
            elif op == progcode.LOOP:
                axis, m, end, depth = ins[1:5]
                stack.append(np.zeros(len(live), bool))
                if not group["operands"][m]["width"]:
                    at = end
                    continue
                saved[depth], idx[axis] = idx[axis], 0
                stack.append(full(("m", m, 0), lambda: ex.mask_bit(m, 0),
                                  idx)[cells])
            elif op == progcode.ENDLOOP:
                axis, m, body, depth = ins[1:5]
                part = stack.pop()
                stack.append(stack.pop() | part)
                nxt = idx[axis] + 1
                if nxt < group["operands"][m]["width"] and \
                        (~stack[-1] & live).any():
                    idx[axis] = nxt
                    stack.append(full(("m", m, nxt),
                                      lambda: ex.mask_bit(m, nxt),
                                      idx)[cells])
                    at = body
                else:
                    idx[axis] = saved[depth]
            else:
                assert op == progcode.HALT
                out[cells] = stack[-1] & live
                break
    return out.reshape(B, R)


TILES = (1, 8, 32, "R")


def _hold_tiled(prog, env, want, seed=0):
    """tiled_eval for each tile in TILES, on an all-True and a seeded mask,
    against ``want`` (the program's own value)."""
    group = bind_group(progcode.encode(prog), env, 1)
    rng = np.random.default_rng(seed)
    for p_live in (1.0, 0.6):
        mask = torch.from_numpy(rng.random((env.C + 2, env.R)) < p_live)
        rows = mask[1:1 + env.C].numpy()
        for T in TILES:
            got = tiled_eval(mask, group, env.R if T == "R" else T)
            np.testing.assert_array_equal(got, rows & want)


# ---- the corpora, on the JAX driver's packed groups ---------------------------


def _port_programs(templates):
    tc = TClient(driver=TInterp())
    out = {}
    for t in templates:
        tc.add_template(copy.deepcopy(t))
        kind = t["spec"]["crd"]["spec"]["names"]["kind"]
        out[kind] = tvectorize(tc.driver.templates[kind].policy)
    return out


def _jax_client(templates, constraints, objs, driver):
    c = JClient(driver=driver)
    for t in templates:
        c.add_template(copy.deepcopy(t))
    for k in constraints:
        c.add_constraint(copy.deepcopy(k))
    for o in objs:
        c.add_data(copy.deepcopy(o))
    return c


def _envs(d, tprogs, cols, rv, R, joins=None):
    """(JAX program, port program, JAX env, port env) for each of the JAX
    driver's packed groups over the columns ``cols`` (numpy) of R rows;
    ``joins`` = (mode, JAX plan args, port plan args) binds the join
    plans."""
    _ordered, _cp, groups, _specs, _crow = d._constraint_side()
    kind_of = {id(p): k for k, p in d.programs.items() if p}
    tcols = state_from_numpy(cols, "cpu")
    trv = state_from_numpy(rv, "cpu")
    plans = d._active_join_plans() if joins else ()
    jshared, tshared = {}, {}
    for prog, _start, B, packed in groups:
        tprog = tprogs[kind_of[id(prog)]]
        assert tprog.structure_key() == prog.structure_key()
        params, elems, tables = packed
        keys = [s.key for s in prog.column_specs if s.kind == "keyset"]
        jenv = jv.EvalEnv(
            {s.key: cols[s.key] for s in prog.column_specs
             if s.kind != "keyset"},
            params, elems, tables, {k: cols[k]["ids"] for k in keys}, B, R,
        )
        tparams, telems, ttables = group_params_from_numpy([packed], "cpu")[0]
        tenv = tv.EvalEnv(
            {s.key: tcols[s.key] for s in prog.column_specs
             if s.kind != "keyset"},
            tparams, telems, ttables, {k: tcols[k]["ids"] for k in keys},
            B, R, "cpu",
        )
        if joins and prog.join_plans:
            mode, jargs, targs = joins
            at = [plans.index(p) for p in prog.join_plans]
            jenv.joins = jjk.JoinBinding(mode, prog.join_plans,
                                         [jargs[i] for i in at], rv=rv,
                                         cache=jshared)
            tenv.joins = tjk.JoinBinding(mode, tprog.join_plans,
                                         [targs[i] for i in at], rv=trv,
                                         cache=tshared)
        yield prog, tprog, jenv, tenv


def _hold_all_three(envs):
    """-> groups checked, groups that flag a cell."""
    n = flagged = 0
    for prog, tprog, jenv, tenv in envs:
        want = np.asarray(jv.eval_program(prog, jenv))
        port = tv.eval_program(tprog, tenv).numpy()
        got = bytecode_eval(tprog, tenv)
        assert got.shape == (tenv.C, tenv.R)
        np.testing.assert_array_equal(port, want)
        np.testing.assert_array_equal(got, want)
        n += 1
        flagged += int(got.any())
    return n, flagged


def _rowwise(d):
    reviews = [
        d.target.make_audit_review(thaw(o), api, k, n, ns)
        for o, api, k, n, ns in d.store.iter_objects()
    ]
    _o, _cp, _groups, col_specs, _crow = d._constraint_side()
    rp = pack_reviews(reviews, d.interner, d.store.cached_namespace)
    R = len(rp.arrays["valid"])
    return rp.arrays, extract_columns(reviews, col_specs, d.interner, R), R


@pytest.mark.parametrize("source", ["synthetic", "render_corpus"])
def test_bytecode_bit_equal_on_the_corpora(source):
    if source == "synthetic":
        jclient = jsyn.build_driver(12, 256)
        templates = jsyn.make_templates(12)[0]
        want_groups = 6
    else:
        entries = corpus()
        templates = [t for _n, t, _c, _tier in entries]
        jclient = _jax_client(templates, [c for _n, _t, c, _tier in entries],
                              resources(), _tpu())
        want_groups = None
    d = jclient.driver
    rv, cols, R = _rowwise(d)
    n, flagged = _hold_all_three(_envs(d, _port_programs(templates), cols,
                                       rv, R))
    if want_groups is not None:
        assert n == want_groups
    assert n >= 6 and flagged >= 4


def _tpu():
    d = TpuDriver()
    d.mesh_enabled = False
    d._mesh_cache = None
    return d


def _referential():
    templates, constraints = jsyn.make_referential_templates(6)
    jd = _tpu()
    j = _jax_client(templates, constraints,
                    jsyn.make_referential_objects(240, 1), jd)
    j.audit_capped(20)
    return templates, jd


@pytest.mark.parametrize("mode", ["trace", "tables"])
def test_bytecode_bit_equal_on_the_referential_corpus(mode):
    templates, jd = _referential()
    ap = jd._audit_pack
    plans = jd._active_join_plans()
    kind_ids = [jd.interner.intern(p.remote_kind) for p in plans]
    if mode == "trace":
        rv, cols = ap.rp, ap.cols
        R = len(rv["valid"])
        vocab = jd.interner.snapshot_size()
        jargs = [{"kind_id": np.int32(k)} for k in kind_ids]
        targs = [{"kind_id": k, "vocab": vocab} for k in kind_ids]
    else:
        # a delta dispatch: a row slice (here every row, shuffled) against
        # the host index's tables
        rows = np.random.default_rng(4).permutation(ap.n_rows).astype(
            np.int32)
        rv, cols = take_rows((ap.rp, ap.cols), rows)
        R = len(rows)
        tabs = jd._join_state.delta_tables()
        jargs = [dict(t, kind_id=np.int32(k)) for t, k in zip(tabs, kind_ids)]
        targs = [dict(state_from_numpy(t, "cpu"), kind_id=k)
                 for t, k in zip(tabs, kind_ids)]
    n, flagged = _hold_all_three(_envs(
        jd, _port_programs(templates), cols, rv, R, (mode, jargs, targs)))
    assert n == 3 and flagged >= 2


def test_every_corpus_program_fits_the_kernel():
    templates = (jsyn.make_templates(12)[0]
                 + [t for _n, t, _c, _tier in corpus()]
                 + jsyn.make_referential_templates(3)[0]
                 + [t for _n, t, _c, _o in join_corpus()])
    encoded = 0
    for prog in _port_programs(templates).values():
        if not prog:
            continue
        enc = progcode.encode(prog)
        assert enc.stack <= progcode.MAX_STACK
        assert enc.loops <= progcode.MAX_LOOPS
        assert enc.n_instr <= progcode.MAX_INSTRS
        assert len(enc.operands) <= progcode.MAX_OPERANDS
        assert enc.code.dtype == np.int32
        encoded += 1
    assert encoded >= 20


# ---- seeded single-node cases ---------------------------------------------------

C, R, S, P, K, V, U = 5, 16, 3, 3, 4, 24, 4
ITER = (("spec", "containers", "[]"),)
ITER2 = (("spec", "volumes", "[]"),)
SCALAR = ("scalar", (), ("a",), ())
SCALAR2 = ("scalar", (), ("b",), ())
SLOT = ("slot", ITER, ("image",), ())
SLOT2 = ("slot", ITER, ("name",), ())
VSLOT = ("slot", ITER2, ("name",), ())
KEYS = ("keyset", (("metadata", "labels"),), (), ())
JKEY = ("joinkey", "host")
JSLOT = ("joinkey", "hosts")
PAD = -2


def _typed(rng, shape, wide=False):
    """tcode/sid/num over every type code; numbers small halves, and with
    ``wide`` also -0.0, NaN and infinities."""
    tcode = rng.integers(0, 7, shape).astype(np.int8)
    sid = np.where(tcode == 5, rng.integers(-1, V, shape), -1).astype(np.int32)
    num = np.where(tcode == 4, rng.integers(-4, 5, shape) / 2.0, 0.0)
    if wide:
        odd = rng.random(shape)
        num = np.where((tcode == 4) & (odd < 0.1), -0.0, num)
        num = np.where((tcode == 4) & (odd > 0.9), np.nan, num)
        num = np.where((tcode == 4) & (odd > 0.8) & (odd <= 0.9),
                       np.inf * np.sign(odd - 0.85), num)
    return {"tcode": tcode, "sid": sid, "num": num.astype(np.float64)}


def _env_arrays(seed, P_=P):
    rng = np.random.default_rng(seed)
    slot = _typed(rng, (R, S), wide=True)
    slot["mask"] = rng.random((R, S)) < 0.7
    slot2 = _typed(rng, (R, S))
    slot2["mask"] = slot["mask"]  # aligned with SLOT: one iteration group
    vslot = _typed(rng, (R, 2))
    vslot["mask"] = rng.random((R, 2)) < 0.5
    elem = _typed(rng, (C, P_))
    elem["mask"] = rng.random((C, P_)) < 0.7
    elem["sid"] = np.where(elem["mask"], rng.integers(0, 6, (C, P_)),
                           -1).astype(np.int32)
    keys = rng.integers(0, 6, (R, K)).astype(np.int32)
    keys[rng.random((R, K)) < 0.4] = PAD
    jk = rng.integers(0, 8, R).astype(np.int32)
    jk[rng.random(R) < 0.15] = -1
    jk[rng.random(R) < 0.15] = tjk.UNKNOWN_KEY
    js = rng.integers(0, 8, (R, 2)).astype(np.int32)
    js[rng.random((R, 2)) < 0.2] = tjk.UNKNOWN_KEY
    cols = {SCALAR: _typed(rng, (R,), wide=True), SCALAR2: _typed(rng, (R,)),
            SLOT: slot, SLOT2: slot2, VSLOT: vslot,
            KEYS: {"ids": keys}, JKEY: {"sid": jk},
            JSLOT: {"sid": js, "mask": rng.random((R, 2)) < 0.9}}
    params = {("p",): _typed(rng, (C,), wide=True),
              ("q",): _typed(rng, (C,)),
              ("__lit__", "x"): {"tcode": np.array([5], np.int8),
                                 "sid": np.array([3], np.int32),
                                 "num": np.zeros(1)}}
    elems = {(("arr",), ()): elem,
             (("arr",), ("sub",)): _typed(rng, (C, P_))}
    elems[(("arr",), ("sub",))]["mask"] = elem["mask"]
    tables = {
        0: ((rng.random((U, V)) < 0.5).astype(np.uint8),
            rng.integers(0, U, C).astype(np.int32)),
        1: ((rng.random((U, V)) < 0.5).astype(np.uint8),
            rng.integers(0, U, (C, P_)).astype(np.int32)),
    }
    rv = {"valid": rng.random(R) < 0.9,
          "kind": rng.integers(0, 3, R).astype(np.int32),
          "ns_empty": rng.random(R) < 0.4}
    uk = np.full(8, int(tjk.KEY_INVALID), np.int32)
    uk[:5] = [0, 2, 3, 5, 7]
    uc = np.zeros(8, np.int32)
    uc[:5] = rng.integers(1, 4, 5)
    return cols, params, elems, tables, rv, (uk, uc)


def _plans(m):
    jk = jjk if m is jv else tjk
    return (
        jk.JoinPlan(agg="dup", local_colkey=JKEY, local_slot=False,
                    remote_scope="namespace", remote_kind="Kind",
                    remote_colkey=JKEY, remote_slot=False),
        jk.JoinPlan(agg="count", local_colkey=JSLOT, local_slot=True,
                    remote_scope="cluster", remote_kind="Kind",
                    remote_colkey=JSLOT, remote_slot=True),
    )


def _eval_three(make_clauses, seed, joins=False, P_=P):
    """(JAX eval_program, port eval_program, port bytecode) of one
    program on one seeded environment."""
    cols, params, elems, tables, rv, (uk, uc) = _env_arrays(seed, P_)
    vals = {k: v for k, v in cols.items() if k != KEYS}
    jenv = jv.EvalEnv(vals, params, elems, tables, {KEYS: cols[KEYS]["ids"]},
                      C, R)
    tparams, telems, ttables = group_params_from_numpy(
        [(params, elems, tables)], "cpu")[0]
    tcols = state_from_numpy(cols, "cpu")
    tenv = tv.EvalEnv({k: v for k, v in tcols.items() if k != KEYS}, tparams,
                      telems, ttables, {KEYS: tcols[KEYS]["ids"]}, C, R, "cpu")
    if joins:
        jargs = [{"uk": uk, "uc": uc, "kind_id": np.int32(1)}] * 2
        jenv.joins = jjk.JoinBinding("tables", _plans(jv), jargs, rv=rv)
        targs = [{"uk": torch.from_numpy(uk), "uc": torch.from_numpy(uc),
                  "kind_id": 1}] * 2
        tenv.joins = tjk.JoinBinding("tables", _plans(tv), targs,
                                     rv=state_from_numpy(rv, "cpu"))
    out = []
    for m, env in ((jv, jenv), (tv, tenv)):
        prog = m.VProgram(make_clauses(m), [], [], [],
                          join_plans=_plans(m) if joins else ())
        out.append(np.asarray(m.eval_program(prog, env)))
    prog = tv.VProgram(make_clauses(tv), [], [], [],
                       join_plans=_plans(tv) if joins else ())
    out.append(bytecode_eval(prog, tenv))
    _hold_tiled(prog, tenv, out[0], seed)
    return out


def _held(make_clauses, seeds=range(3), both=True, **kw):
    seen = set()
    for seed in seeds:
        want, port, got = _eval_three(make_clauses, seed, **kw)
        np.testing.assert_array_equal(port, want)
        np.testing.assert_array_equal(got, want)
        seen.update(np.unique(got).tolist())
    if both:
        assert seen == {False, True}, "the seeded cases must hit both"


OPS = ["==", "!=", "<", "<=", ">", ">="]


@pytest.mark.parametrize("op", OPS)
def test_cmp_every_op_across_the_seven_tcodes(op):
    """Scalar (every tcode, -0.0, NaN, infinities) against a parameter,
    slot against a literal, element against a slot, both defaults."""
    tcodes = set()
    for seed in range(3):
        tcodes |= set(_env_arrays(seed)[0][SCALAR]["tcode"].tolist())
    assert tcodes == set(range(7))
    for unk in (True, False):
        _held(lambda m: [
            m.Clause((m.Cmp(op, m.ColRef(SCALAR, False), m.ParamRef(("p",)),
                            unknown_default=unk),)),
        ], both=False)
        _held(lambda m: [
            m.Clause((m.Cmp(op, m.ColRef(SLOT, True), m.Lit(0.5),
                            unknown_default=unk),), slot_iter=ITER),
            m.Clause((m.Cmp(op, m.ColRef(SCALAR2, False), m.Lit("x"),
                            unknown_default=unk),
                      m.Cmp(op, m.Lit(True), m.ColRef(SCALAR, False)))),
        ], both=False)
        _held(lambda m: [m.Clause((m.AnyParam(("arr",), (
            m.Cmp(op, m.ParamElemRef(("arr",), ("sub",)),
                  m.ColRef(SLOT, True), unknown_default=unk),)),),
            slot_iter=ITER)], both=False)


def test_truthy_const_and_boolops():
    _held(lambda m: [
        m.Clause((m.Truthy(m.ColRef(SCALAR, False)),
                  m.BoolOp("not", (m.Truthy(m.ParamRef(("q",))),)))),
        m.Clause((m.BoolOp("or", (
            m.Truthy(m.ColRef(SCALAR2, False), negate=True),
            m.BoolOp("and", (m.Const(True), m.Truthy(m.ParamRef(("p",))))),
            m.Const(False))),)),
    ])
    _held(lambda m: [m.Clause((m.Const(False),)), m.Clause(())], both=False)
    # no clauses at all: every row False
    for got in _eval_three(lambda m: [], 0):
        assert not got.any() and got.shape == (C, R)


STRPRED_CASES = {
    "review_scalar": lambda m: [m.Clause((
        m.StrPred("startswith", m.ColRef(SCALAR, False), m.ParamRef(("p",)),
                  pred_id=0),))],
    "review_slot_negated": lambda m: [m.Clause((
        m.StrPred("startswith", m.ColRef(SLOT, True), m.Lit("x"),
                  pred_id=0, negate=True),), slot_iter=ITER)],
    "constraint_side": lambda m: [m.Clause((
        m.StrPred("contains", m.ParamRef(("p",)), m.Lit("x"), pred_id=0),))],
    "per_element": lambda m: [m.Clause((m.AnyParam(("arr",), (
        m.StrPred("startswith", m.ColRef(SCALAR, False),
                  m.ParamElemRef(("arr",)), pred_id=1),)),))],
    "per_element_constraint_side": lambda m: [m.Clause((m.AnyParam(("arr",), (
        m.StrPred("endswith", m.ParamElemRef(("arr",), ("sub",)),
                  m.ParamElemRef(("arr",)), pred_id=1),)),))],
}


@pytest.mark.parametrize("case", sorted(STRPRED_CASES))
def test_strpred_on_each_side(case):
    _held(STRPRED_CASES[case], seeds=range(4))


@pytest.mark.parametrize("op", [">", ">=", "<", "<=", "==", "!="])
@pytest.mark.parametrize("orient", ["params_minus_keys", "keys_minus_params"])
def test_setcount_both_orientations(op, orient):
    pids, keys = ("paramids", (("arr",), ())), ("keyset", KEYS)
    left, right = (pids, keys) if orient == "params_minus_keys" else (keys, pids)
    _held(lambda m: [m.Clause((m.SetCountCmp(left, right, op, 1),))],
          both=False)


def test_anyparam_masked_elements_and_empty_axis():
    inner = (lambda m: (
        m.Cmp("==", m.ParamElemRef(("arr",)), m.ColRef(SCALAR, False),
              unknown_default=False),
        m.Truthy(m.ParamElemRef(("arr",), ("sub",))),))
    _held(lambda m: [m.Clause((m.AnyParam(("arr",), inner(m)),))])
    _held(lambda m: [m.Clause((m.AnyParam(("arr",), (m.Const(True),)),))],
          both=False)
    # P = 0: AnyParam is False, its negation True
    for P_ in (0, 1):
        _held(lambda m: [m.Clause((
            m.BoolOp("not", (m.AnyParam(("arr",), inner(m)),)),
            m.Truthy(m.ColRef(SCALAR, False))))], both=P_ == 0, P_=P_)


def test_reduce_slots_and_slot_clauses():
    _held(lambda m: [
        m.Clause((m.Truthy(m.ColRef(SCALAR, False)),
                  m.ReduceSlots((m.Cmp("==", m.ColRef(SLOT, True),
                                       m.ColRef(SLOT2, True)),
                                 m.Truthy(m.ColRef(SCALAR2, False))),
                                ITER))),
        m.Clause((m.Truthy(m.ColRef(SLOT2, True), negate=True),
                  m.AnyParam(("arr",), (m.Cmp(
                      "!=", m.ParamElemRef(("arr",)), m.ColRef(SLOT, True)),)),
                  m.Truthy(m.ParamRef(("q",)))), slot_iter=ITER),
        m.Clause((), slot_iter=ITER2),
    ])


def test_slot_mask_is_the_first_column_of_the_iteration_group():
    """Two slot columns share ITER: _slot_mask binds the first one in
    env.cols order that has a mask; give them different masks and both
    orders."""
    cols, params, elems, tables, _rv, _t = _env_arrays(7)
    cols[SLOT2]["mask"] = ~cols[SLOT]["mask"]
    for order in ((SLOT, SLOT2), (SLOT2, SLOT)):
        tenv = tv.EvalEnv(state_from_numpy({k: cols[k] for k in order},
                                           "cpu"), {}, {}, {}, {}, C, R, "cpu")
        jenv = jv.EvalEnv({k: cols[k] for k in order}, {}, {}, {}, {}, C, R)
        progs = [m.VProgram([m.Clause((m.Truthy(m.ColRef(SLOT, True)),),
                                      slot_iter=ITER)], [], [], [])
                 for m in (jv, tv)]
        want = np.asarray(jv.eval_program(progs[0], jenv))
        np.testing.assert_array_equal(
            tv.eval_program(progs[1], tenv).numpy(), want)
        np.testing.assert_array_equal(bytecode_eval(progs[1], tenv), want)
        first = cols[order[0]]["mask"]
        t = cols[SLOT]["tcode"]
        np.testing.assert_array_equal(
            want[0], ((t != 0) & (t != 2) & first).any(axis=1))


@pytest.mark.parametrize("op", OPS)
def test_joincmp_unknown_key_and_exclude_self(op):
    for excl in (False, True):
        _held(lambda m: [
            m.Clause((m.JoinCmp(0, op, m.Lit(1), exclude_self=excl),)),
            m.Clause((m.JoinCmp(0, op, m.ParamRef(("p",)),
                                unknown_default=False, exclude_self=excl),
                      m.Truthy(m.ColRef(SCALAR2, False)))),
        ], joins=True)
        _held(lambda m: [
            m.Clause((m.JoinCmp(1, op, m.Lit(2), slot=True,
                                exclude_self=excl),
                      m.Truthy(m.ColRef(SCALAR, False))), slot_iter=ITER2),
        ], joins=True)


def test_joincmp_without_a_binding_is_its_default():
    for unk in (True, False):
        outs = _eval_three(lambda m: [m.Clause((m.JoinCmp(
            0, "<", m.Lit(1), unknown_default=unk),))], 0)
        for got in outs:
            assert (got == unk).all()


# ---- refusals ----------------------------------------------------------------------


REFUSED = {
    "AnySlots must be handled at clause level": lambda m: [m.Clause((
        m.AnySlots((m.Truthy(m.ColRef(SLOT, True)),)),), slot_iter=ITER)],
    "nested slot reduction is not supported": lambda m: [m.Clause((
        m.ReduceSlots((m.ReduceSlots((m.Truthy(m.ColRef(SCALAR, False)),),
                                     ITER),), ITER),))],
    "slot conditions without slot_iter": lambda m: [m.Clause((
        m.Truthy(m.ColRef(SLOT, True)),))],
    "ParamElemRef outside AnyParam": lambda m: [m.Clause((
        m.Cmp("==", m.ParamElemRef(("arr",)), m.ColRef(SCALAR, False)),))],
    "unsupported literal": lambda m: [m.Clause((
        m.Cmp("==", m.Lit(None), m.ColRef(SCALAR, False)),))],
    "unsupported SetCountCmp side combination": lambda m: [m.Clause((
        m.SetCountCmp(("keyset", KEYS), ("keyset", KEYS), ">", 0),))],
}


@pytest.mark.parametrize("msg", sorted(REFUSED))
def test_encoder_refuses_what_eval_program_refuses(msg):
    cols, params, elems, tables, _rv, _t = _env_arrays(0)
    tenv = tv.EvalEnv(state_from_numpy(
        {k: v for k, v in cols.items() if k != KEYS}, "cpu"),
        *group_params_from_numpy([(params, elems, tables)], "cpu")[0],
        {KEYS: torch.from_numpy(cols[KEYS]["ids"])}, C, R, "cpu")
    prog = tv.VProgram(REFUSED[msg](tv), [], [], [])
    with pytest.raises(ValueError, match=msg):
        tv.eval_program(prog, tenv)
    with pytest.raises(ValueError, match=msg):
        progcode.encode(prog)


def test_encoder_refuses_a_stack_past_the_kernel_bound():
    def nest(m, depth):
        node = m.Truthy(m.ColRef(SCALAR, False))
        for _ in range(depth):
            node = m.BoolOp("and", (m.Truthy(m.ParamRef(("p",))), m.BoolOp(
                "or", (m.Const(False), node))))
        return node

    fits = progcode.encode(tv.VProgram([tv.Clause((nest(tv, 7),))], [], [],
                                       []))
    assert fits.stack <= progcode.MAX_STACK
    deep = tv.VProgram([tv.Clause((nest(tv, 20),))], [], [], [])
    with pytest.raises(ValueError, match="stack"):
        progcode.encode(deep)
    # eval_program itself has no such bound: the bytecode of a program that
    # fits agrees with it
    _held(lambda m: [m.Clause((nest(m, 7),))], both=False)


def test_plain_counts_the_instructions_the_kernel_runs():
    """program_eval_plain's instruction count: none on an all-False mask,
    one HALT and no more than the whole stream a cell otherwise, and the
    mask it leaves unchanged by counting."""
    cols, params, elems, tables, _rv, _t = _env_arrays(2)
    tcols = state_from_numpy({k: v for k, v in cols.items() if k != KEYS},
                             "cpu")
    tenv = tv.EvalEnv(tcols, *group_params_from_numpy(
        [(params, elems, tables)], "cpu")[0],
        {KEYS: torch.from_numpy(cols[KEYS]["ids"])}, C, R, "cpu")
    prog = tv.VProgram(STRPRED_CASES["per_element"](tv) + [tv.Clause((
        tv.Truthy(tv.ColRef(SLOT, True)),), slot_iter=ITER)], [], [], [])
    enc = progcode.encode(prog)
    group = bind_group(enc, tenv, 0)
    ops = []
    program_eval_plain(torch.zeros((C, R), dtype=torch.bool), [group], ops)
    assert ops == [0]
    mask = torch.rand((C, R), generator=torch.Generator().manual_seed(0)) < 0.5
    plain = program_eval_plain(mask.clone(), [group])
    counted, ops = mask.clone(), []
    program_eval_plain(counted, [group], ops)
    assert torch.equal(counted, plain)
    live = int(mask.sum())
    # every live cell runs at least the first condition's loop set-up and
    # HALT; at most every instruction, each loop body once per element
    assert 2 * live <= ops[0] <= live * enc.n_instr * (P + 1) * (S + 1)


# ---- K9's control rule and launch ------------------------------------------------


def _edge_groups(R, S, P, seed):
    """chip_smoke's edge programs (every node kind, nested loops, a deep
    stack, no clauses), bound on the CPU as groups of one launch."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    groups, start = [], 0
    for prog in chip_smoke.edge_programs():
        env = chip_smoke._edge_env(rng, torch.device("cpu"), 4, R, S, P)
        groups.append(bind_group(progcode.encode(prog), env, start))
        start += 4
    return groups, start, rng


@pytest.mark.parametrize("R,S,P", [(1, 3, 3), (17, 3, 1), (40, 0, 3),
                                   (24, 3, 0)])
def test_tiled_control_rule_on_the_edge_programs(R, S, P):
    """Tiles that straddle rows (T past R) and cut them (T under R), masks
    that differ lane by lane: the tile model equals the plain executor."""
    groups, C, rng = _edge_groups(R, S, P, R + S + P)
    r = np.arange(R)
    for pattern in (np.ones(R, bool), r % 2 == 0, r % 8 == 7,
                    rng.random(R) < 0.5):
        mask = torch.from_numpy((rng.random((C, R)) < 0.8) & pattern)
        want = program_eval_plain(mask.clone(), groups)
        for g in groups:
            rows = want[g["start"]:g["start"] + g["B"]].numpy()
            for T in TILES:
                np.testing.assert_array_equal(
                    tiled_eval(mask, g, R if T == "R" else T), rows)


def test_executed_instruction_count_is_unchanged_by_the_loop_arguments():
    """program_eval_plain's count of the instructions K9 executes (its
    bound's operations) on seeded inputs: the numbers the bytecode gave
    before LOOP carried its depth and ENDLOOP its axis, mask, body and
    depth."""
    cols, params, elems, tables, _rv, _t = _env_arrays(2)
    tenv = tv.EvalEnv(state_from_numpy(
        {k: v for k, v in cols.items() if k != KEYS}, "cpu"),
        *group_params_from_numpy([(params, elems, tables)], "cpu")[0],
        {KEYS: torch.from_numpy(cols[KEYS]["ids"])}, C, R, "cpu")
    mask = torch.rand((C, R), generator=torch.Generator().manual_seed(0)) < 0.6
    counts = []
    for name in sorted(STRPRED_CASES):
        ops = []
        prog = tv.VProgram(STRPRED_CASES[name](tv), [], [], [])
        program_eval_plain(mask.clone(), [bind_group(progcode.encode(prog),
                                                     tenv, 0)], ops)
        counts += ops
    assert counts == [98, 614, 554, 98, 338]
    rng = np.random.default_rng(0)
    want = {(300, 3, 3): [6221, 18627, 6273, 8710, 34166, 32157, 16467,
                          17599, 1614, 52233],
            (64, 0, 1): [1442, 5141, 1372, 1466, 1738, 3696, 2116, 3869,
                         402, 11169],
            (50, 3, 0): [1195, 2868, 1085, 1268, 2114, 828, 2619, 2694, 286,
                         11520]}
    import chip_smoke

    for (R_, S_, P_), counts in want.items():
        groups, start = [], 0
        for prog in chip_smoke.edge_programs():
            env = chip_smoke._edge_env(rng, torch.device("cpu"), 4, R_, S_,
                                       P_)
            groups.append(bind_group(progcode.encode(prog), env, start))
            start += 4
        ops = []
        program_eval_plain(torch.from_numpy(rng.random((start, R_)) < 0.7),
                           groups, ops)
        assert ops == counts, (R_, S_, P_)


def test_pack_launch_offsets_and_alignment():
    """The blob K9 reads: G headers and NOP operand rows of 8 int64 words,
    then the code, whole words, then the ranges of rows no group covers;
    each group's first block follows the
    blocks of the groups before it, so no block holds two groups; a group
    of B = 0 is dropped; rows outside the mask are refused."""
    groups, C, _rng = _edge_groups(1025, 3, 3, 5)
    groups.insert(3, dict(groups[3], B=0))
    lp = tprogram.pack_launch(groups, C, 1025, torch.device("cpu"))
    live = [g for g in groups if g["B"]]
    G, NOP = lp["G"], lp["NOP"]
    assert G == len(live) == 10
    assert NOP == sum(len(g["operands"]) for g in live)
    blob = lp["blob"]
    n_code = sum(len(g["code"]) for g in live)
    assert blob.dtype == np.int64
    # the code, whole words, then the rows of no group: U and U ranges
    free = tprogram.rows_of_no_group(live, C)
    tail = 8 * G + 8 * NOP + -(-n_code // 2)
    assert len(blob) == tail + 1 + 2 * len(free)
    assert blob[tail:].tolist() == [len(free)] + [x for r in free for x in r]
    hdr = blob[:8 * G].reshape(G, 8)
    blocks = code = ops = 0
    for h, g in zip(hdr.tolist(), live):
        assert h == [g["start"], g["B"], blocks, code, len(g["code"]), ops,
                     len(g["operands"]), g["stack"]]
        V = tprogram.ROWS_PER_THREAD
        per_row = -(-1025 // (32 * V)) * 32  # 1025 >= 32 V: a warp's tiles
        assert tprogram.items_per_row(1025) == per_row
        assert tprogram.group_blocks(g["B"], 1025) == -(-g["B"] * per_row
                                                         // (256 * 8))
        blocks += tprogram.group_blocks(g["B"], 1025)
        code += len(g["code"])
        ops += len(g["operands"])
    assert lp["blocks"] == blocks
    assert lp["max_code"] == max(len(g["code"]) for g in live)
    assert lp["max_ops"] == max(len(g["operands"]) for g in live)
    words = blob[8 * G + 8 * NOP:tail].view(np.int32)
    np.testing.assert_array_equal(
        words[:n_code], np.concatenate([g["code"] for g in live]))
    assert (words[n_code:] == 0).all()
    table = blob[8 * G:8 * G + 8 * NOP].reshape(NOP, 8)
    kinds = [o["kind"] for g in live for o in g["operands"]]
    assert table[:, 0].tolist() == kinds
    # a review's 8 rows: V consecutive rows an item, every thread busy on
    # up to ITEMS items
    items = 8 // tprogram.ROWS_PER_THREAD
    assert tprogram.items_per_row(8) == items
    assert tprogram.group_blocks(256 * 8 // items, 8) == 1
    assert tprogram.group_blocks(256 * 8 // items + 1, 8) == 2
    with pytest.raises(ValueError, match="2\\^31"):
        tprogram.group_blocks(2 ** 20, 2 ** 13 * tprogram.ROWS_PER_THREAD)
    bad = [dict(live[0], start=C - 1)]
    with pytest.raises(ValueError, match="outside the mask"):
        tprogram.pack_launch(bad, C, 1025, torch.device("cpu"))


def test_k9_geometry_matches_the_kernel_source():
    """ROWS_PER_THREAD, THREADS, ITEMS and the instruction width as
    kernels/program.cu has them."""
    import re

    src = (pathlib.Path(tdev.__file__).parent / "kernels"
           / "program.cu").read_text()
    assert re.search(r"constexpr int THREADS = (\d+);", src).group(1) == \
        str(tprogram.THREADS)
    assert re.search(r"constexpr int ROWS = (\d+);", src).group(1) == \
        str(tprogram.ROWS_PER_THREAD)
    assert re.search(r"constexpr int ITEMS = (\d+);", src).group(1) == \
        str(tprogram.ITEMS)
    assert re.search(r"constexpr int WIDTH = (\d+);", src).group(1) == \
        str(progcode.WIDTH)


@pytest.mark.parametrize("R", [1, 17, 1025])
def test_rows_of_no_group_sit_where_the_kernel_reads_them(R):
    """K9's review mode packs the rows no group covers from the ranges
    after the code: program.cu finds them from the last header (G
    headers, NOP operands, then the code up to the last group's end,
    padded to whole words).  They are the blob's last words: U, then U
    (begin, end) ranges, which cover exactly the rows outside every group
    of B > 0."""
    groups, C, _rng = _edge_groups(R, 3, 3, R)
    C += 3  # rows of no group after the last group
    for live in (groups, groups[:1], groups[1:3],
                 [groups[0], dict(groups[1], B=0), groups[4]]):
        lp = tprogram.pack_launch(live, C, R, torch.device("cpu"))
        blob, G, NOP = lp["blob"], lp["G"], lp["NOP"]
        last = blob[8 * (G - 1):8 * G]
        at = 8 * G + 8 * NOP + (last[3] + last[4] + 1) // 2
        U = blob[at]
        assert len(blob) == at + 1 + 2 * U
        ranges = blob[at + 1:].reshape(U, 2)
        free = np.zeros(C, bool)
        for b, e in ranges.tolist():
            assert 0 <= b < e <= C
            free[b:e] = True
        covered = np.zeros(C, bool)
        for g in live:
            covered[g["start"]:g["start"] + g["B"]] = True
        np.testing.assert_array_equal(free, ~covered)


def test_k9_review_mode_matches_the_kernel_source():
    """program.cu finds the rows of no group as pack_launch lays them out,
    and packs from memory with packbits.cuh, the body K10 runs."""
    import re

    kdir = pathlib.Path(tdev.__file__).parent / "kernels"
    src = (kdir / "program.cu").read_text()
    assert '#include "packbits.cuh"' in src
    assert re.search(r"blob \+ \(long long\)G \* HDRW \+\s*"
                     r"\(long long\)NOP \* OPW \+\s*\(hl\[3\] \+ hl\[4\] "
                     r"\+ 1\) / 2", src)
    assert re.search(r"constexpr int HDRW = (\d+);", src).group(1) == "8"
    assert re.search(r"constexpr int OPW = (\d+);", src).group(1) == "8"
    assert "gk::pack_byte(mask, autoreject, C, R, vec, t)" in src
    k10 = (kdir / "packbits.cu").read_text()
    assert '#include "packbits.cuh"' in k10
    assert "gk::pack_byte(mask, autoreject, C, R, vec, t)" in k10


@pytest.fixture
def launched(monkeypatch):
    """device.launch recording its arguments, on CPU tensors."""
    calls = []
    monkeypatch.setattr(tdev, "launch",
                        lambda name, device, *args: calls.append(
                            (name, args)))
    monkeypatch.setattr(tdev, "stream", lambda t: 0)
    monkeypatch.setattr(tdev, "upload",
                        lambda a, dev: torch.from_numpy(np.array(a)))
    return calls


# K9's launch arguments of a launch that packs nothing (autoreject, out,
# C) and of one that writes no delta columns (resident, its columns, idx,
# out, the extra blocks)
NO_PACK = (None, None, 0)
NO_DELTA = (None, 0, None, None, 0)


def _review_call(R=8, C_extra=2):
    groups, C, rng = _edge_groups(R, 3, 3, 11)
    C += C_extra  # rows of no group
    mask = torch.from_numpy(rng.random((C, R)) < 0.7)
    rej = torch.from_numpy(rng.random((C, R)) < 0.3)
    return groups, mask, rej


def test_review_launches_k9_once_with_the_pack(launched):
    groups, mask, rej = _review_call()
    out = torch.empty((2 * mask.shape[0], 1), dtype=torch.uint8)
    tprogram.program_eval_cuda(mask, groups, pack=(rej, out))
    [(name, args)] = launched
    assert name == "program_pack"
    lp = tprogram.pack_launch(groups, *mask.shape, torch.device("cpu"))
    assert args[1:] == (lp["G"], lp["NOP"], mask.data_ptr(), 8,
                        lp["blocks"], lp["max_code"], lp["max_ops"],
                        rej.data_ptr(), out.data_ptr(), mask.shape[0],
                        *NO_DELTA, 0)


def test_sweep_passes_no_pack_output(launched):
    groups, mask, _rej = _review_call(R=1025)
    tprogram.program_eval_cuda(mask, groups)
    [(name, args)] = launched
    assert name == "program" and args[-9:] == (*NO_PACK, *NO_DELTA, 0)


@pytest.mark.parametrize("groups_of", [lambda g: [], lambda g: [
    dict(g[0], B=0)]])
def test_a_side_without_group_rows_launches_k10_alone(launched, groups_of):
    groups, mask, rej = _review_call()
    out = torch.empty((2 * mask.shape[0], 1), dtype=torch.uint8)
    tprogram.program_eval_cuda(mask, groups_of(groups), pack=(rej, out))
    [(name, args)] = launched
    assert name == "packbits"
    assert args == (mask.data_ptr(), rej.data_ptr(), *mask.shape, 1,
                    out.data_ptr(), 0)


def test_past_the_row_limit_k10_packs_after_k9(launched, monkeypatch):
    monkeypatch.setattr(tprogram, "PACK_IN_K9_MAX_ROWS", 16)
    for R, want in ((16, ["program_pack"]), (17, ["program", "packbits"])):
        launched.clear()
        groups, mask, rej = _review_call(R=R)
        out = torch.empty((2 * mask.shape[0], -(-R // 8)),
                          dtype=torch.uint8)
        tprogram.program_eval_cuda(mask, groups, pack=(rej, out))
        assert [n for n, _a in launched] == want
        if len(want) == 2:
            assert launched[0][1][-9:] == (*NO_PACK, *NO_DELTA, 0)
            assert launched[1][1][5] == out.data_ptr()


def test_the_pack_arguments_are_checked(launched):
    groups, mask, rej = _review_call()
    C = mask.shape[0]
    bad = [((rej, torch.empty((2 * C, 2), dtype=torch.uint8)), ValueError),
           ((rej, torch.empty((2 * C, 1), dtype=torch.int8)), TypeError),
           ((rej[:-1], torch.empty((2 * C, 1), dtype=torch.uint8)),
            ValueError)]
    for pack, err in bad:
        with pytest.raises(err):
            tprogram.program_eval_cuda(mask, groups, pack=pack)
        with pytest.raises(err):
            program_eval(mask, groups, pack=pack)
    assert not launched


def test_program_eval_packs_with_the_plain_versions_on_the_cpu():
    """On the CPU the pack is program_eval_plain, then
    pack_review_masks_plain of the result; nothing is launched."""
    from gatekeeper_tpu_torch.ops import packbits

    groups, mask, rej = _review_call(R=13)
    out = torch.full((2 * mask.shape[0], 2), 0xA5, dtype=torch.uint8)
    tdev.reset_launches()
    got = program_eval(mask.clone(), groups, pack=(rej, out))
    want = program_eval_plain(mask.clone(), groups)
    assert torch.equal(got, want)
    assert torch.equal(out, packbits.pack_review_masks_plain(want, rej))
    assert all(v == 0 for v in tdev.launches.values())


def _delta_call(R=8, C_extra=2, Rt=40):
    """A delta launch's inputs: the groups over a [C, R] mask with rows of
    no group, a resident [C, Rt] mask, the indices (the first, the last
    and padding) and the output."""
    groups, mask, _rej = _review_call(R=R, C_extra=C_extra)
    C = mask.shape[0]
    rng = np.random.default_rng(R)
    resident = torch.from_numpy(rng.random((C, Rt)) < 0.5)
    idx = rng.integers(0, Rt, R).astype(np.int32)
    idx[0], idx[1], idx[-2:] = 0, Rt - 1, idx[-3]
    out = torch.empty((C, 2 * R), dtype=torch.int8)
    return groups, mask, (resident, torch.from_numpy(idx), out)


def test_delta_launches_k9_once_with_the_columns(launched):
    """K9's delta mode: the resident mask, its columns, the indices, the
    output and the blocks for the rows of no group after the groups'; no
    pack output, and no K5."""
    for R in (8, 16, tprogram.DELTA_IN_K9_MAX_ROWS):
        launched.clear()
        groups, mask, delta = _delta_call(R=R)
        tprogram.program_eval_cuda(mask, groups, delta=delta)
        [(name, args)] = launched
        assert name == "program_delta"
        C = mask.shape[0]
        lp = tprogram.pack_launch(groups, C, R, torch.device("cpu"))
        assert tprogram.rows_of_no_group(groups, C)
        resident, idx, out = delta
        assert args[1:] == (lp["G"], lp["NOP"], mask.data_ptr(), R,
                            lp["blocks"], lp["max_code"], lp["max_ops"],
                            None, None, C, resident.data_ptr(), 40,
                            idx.data_ptr(), out.data_ptr(),
                            tprogram.gather_blocks(C, R), 0)


def test_gather_blocks_give_a_thread_a_unit_of_each_row():
    """A delta launch's extra blocks: a thread a unit of ROWS_PER_THREAD
    columns of a row, 256 threads a block, at most GATHER_BLOCKS_MAX."""
    V, T = tprogram.ROWS_PER_THREAD, tprogram.THREADS
    assert V == 8 and T == 256
    assert tprogram.gather_blocks(0, 256) == 0
    assert tprogram.gather_blocks(1, 8) == 1
    assert tprogram.gather_blocks(256, 8) == 1
    assert tprogram.gather_blocks(257, 8) == 2
    assert tprogram.gather_blocks(1024, 8) == 4
    assert tprogram.gather_blocks(1024, 256) == 128
    assert tprogram.gather_blocks(5, 13) == 1
    assert tprogram.gather_blocks(10 ** 6, 256) == \
        tprogram.GATHER_BLOCKS_MAX


@pytest.mark.parametrize("groups_of", [lambda g: [], lambda g: [
    dict(g[0], B=0)]])
def test_a_delta_without_group_rows_launches_k5_alone(launched, groups_of):
    groups, mask, delta = _delta_call()
    tprogram.program_eval_cuda(mask, groups_of(groups), delta=delta)
    [(name, args)] = launched
    resident, idx, out = delta
    assert name == "delta"
    assert args == (resident.data_ptr(), mask.shape[0], 40, idx.data_ptr(),
                    8, mask.data_ptr(), out.data_ptr(), 0)


def test_past_the_delta_row_limit_k5_writes_after_k9(launched, monkeypatch):
    monkeypatch.setattr(tprogram, "DELTA_IN_K9_MAX_ROWS", 8)
    for R, want in ((8, ["program_delta"]), (16, ["program", "delta"])):
        launched.clear()
        groups, mask, delta = _delta_call(R=R)
        tprogram.program_eval_cuda(mask, groups, delta=delta)
        assert [n for n, _a in launched] == want
        if len(want) == 2:
            assert launched[0][1][-9:] == (*NO_PACK, *NO_DELTA, 0)
            assert launched[1][1][6] == delta[2].data_ptr()


def test_pack_and_delta_together_are_refused(launched):
    groups, mask, delta = _delta_call()
    _g, _m, rej = _review_call()
    pack = (rej, torch.empty((2 * mask.shape[0], 1), dtype=torch.uint8))
    for fn in (tprogram.program_eval_cuda, program_eval):
        with pytest.raises(ValueError, match="not both"):
            fn(mask, groups, pack=pack, delta=delta)
    assert not launched


def test_the_delta_arguments_are_checked(launched):
    groups, mask, (resident, idx, out) = _delta_call()
    C = mask.shape[0]
    bad = [((resident[:-1], idx, out), ValueError),
           ((resident.to(torch.uint8), idx, out), TypeError),
           ((resident, idx[:-1], out), ValueError),
           ((resident, idx.long(), out), TypeError),
           ((resident, idx, torch.empty((C, 15), dtype=torch.int8)),
            ValueError),
           ((resident, idx, out.to(torch.uint8)), TypeError)]
    for delta, err in bad:
        with pytest.raises(err):
            tprogram.program_eval_cuda(mask, groups, delta=delta)
        with pytest.raises(err):
            program_eval(mask, groups, delta=delta)
    assert not launched


def test_program_eval_writes_delta_columns_with_the_plain_versions_on_the_cpu():
    """On the CPU the delta columns are program_eval_plain, then
    delta_columns_plain of the result; nothing is launched."""
    from gatekeeper_tpu_torch.ops import delta as tdelta

    groups, mask, (resident, idx, out) = _delta_call(R=16)
    out.fill_(7)
    tdev.reset_launches()
    got = program_eval(mask.clone(), groups, delta=(resident, idx, out))
    want = program_eval_plain(mask.clone(), groups)
    assert torch.equal(got, want)
    assert torch.equal(out, tdelta.delta_columns_plain(resident, idx, want))
    assert torch.equal(out[:, :16], resident[:, idx.long()].to(torch.int8))
    assert all(v == 0 for v in tdev.launches.values())


def test_k9_delta_mode_matches_the_kernel_source():
    """program.cu's delta mode: its own instantiation, the rows of no
    group found as pack_launch lays them out, the gather by the blocks
    after the groups'."""
    import re

    src = (pathlib.Path(tdev.__file__).parent / "kernels"
           / "program.cu").read_text()
    assert "template <int V, int STEP, bool DELTA>" in src
    assert re.search(r"if \(DELTA && blockIdx\.x >= \(unsigned\)nblocks\)",
                     src)
    assert re.search(r"delta_gather\(blob \+ \(long long\)G \* HDRW \+ "
                     r"\(long long\)NOP \* OPW \+\s*\(hl\[3\] \+ hl\[4\] "
                     r"\+ 1\) / 2", src)
    assert "gridDim.x - nblocks" in src


@pytest.fixture
def routed(launched, monkeypatch):
    """The driver's kernel calls through the CUDA wrappers on CPU tensors:
    each wrapper's launches recorded (``launched``), then its plain
    version's result returned."""
    from gatekeeper_tpu_torch.ops import delta as tdelta
    from gatekeeper_tpu_torch.ops import driver as tdriver
    from gatekeeper_tpu_torch.ops import joinlookup, matchkernel

    def both(cuda, plain):
        def call(*a, **k):
            cuda(*a, **k)
            return plain(*a, **k)
        return call

    def k5(mask, idx, new):
        return tdelta.delta_columns_cuda(
            mask, tdelta.delta_index(idx, mask.shape[1], mask.device), new)

    monkeypatch.setattr(tdriver, "match_kernel", both(
        matchkernel.match_kernel_cuda, matchkernel.match_kernel))
    monkeypatch.setattr(tdriver, "program_eval", both(
        tprogram.program_eval_cuda, program_eval))
    monkeypatch.setattr(tdriver, "delta_columns", both(
        k5, tdelta.delta_columns))
    monkeypatch.setattr(tv, "join_lookup_many", both(
        joinlookup.join_lookup_many_cuda, joinlookup.join_lookup_many_plain))
    monkeypatch.setattr(tv, "join_lookup", both(
        joinlookup.join_lookup_cuda, joinlookup.join_lookup_plain))
    return launched


def _moved_ingress(client):
    """An Ingress of the referential corpus moved to a fresh host."""
    from gatekeeper_tpu_torch.engine.value import thaw as tthaw

    ing = next(o for o, *_r in client.driver.store.iter_objects()
               if o["kind"] == "Ingress")
    moved = copy.deepcopy(tthaw(ing))
    moved["spec"]["rules"][0]["host"] = "moved.corp.io"
    return moved


def test_one_card_delta_sweep_launches_k1_one_k8_and_k9s_delta_mode(routed):
    """A referential delta sweep on one device: K1, K8's table mode once
    for every lookup of its groups, and K9 in its delta mode, which writes
    the before | after columns; no K5 and no lookup of its own."""
    client = tsyn.build_referential_driver(6, 120, device="cpu")
    oracle = tsyn.build_referential_oracle(6, 120)
    client.audit_capped(20)
    moved = _moved_ingress(client)
    for c in (client, oracle):
        c.add_data(copy.deepcopy(moved))
    routed.clear()
    got, totals = client.audit_capped(20)
    assert "delta_rows" in client.driver.last_sweep_stats
    names = [n for n, _a in routed]
    assert sorted(names) == ["joinlookup_table", "match", "program_delta"]
    [(_n, largs)] = [c for c in routed if c[0] == "joinlookup_table"]
    assert largs[1] == 3  # the corpus's three (plan, exclude_self) lookups
    want, want_totals = oracle.audit_capped(20)
    assert tsyn.audit_result_sig(got.results()) == \
        tsyn.audit_result_sig(want.results())
    assert totals == want_totals


def test_mesh_delta_sweep_launches_k5_on_each_owning_shard(routed,
                                                            monkeypatch):
    """Under a mesh the resident mask is a slab a shard: K9 runs without
    the delta mode and K5 gathers on each owning shard."""
    from gatekeeper_tpu_torch.engine.value import thaw as tthaw
    from gatekeeper_tpu_torch.parallel import mesh as pm

    monkeypatch.setenv(pm.VIRTUAL_DEVICES_ENV, "2")
    client = tsyn.build_driver(4, 40, device="cpu")
    client.driver.set_mesh(True, width=2)
    client.audit_capped(20)
    ap = client.driver._audit_pack
    for r in (1, ap.capacity - 1 - (ap.capacity - ap.n_rows)):
        obj = tthaw(client.driver.store.get(ap.row_path[r]))
        obj["metadata"].setdefault("labels", {})["moved"] = "y"
        client.add_data(obj)
    routed.clear()
    client.audit_capped(20)
    st = client.driver.last_sweep_stats
    names = [n for n, _a in routed]
    assert st["delta_rows"] == 2.0 and st["delta_shards"] == 2.0
    assert names.count("delta") == 2 and "program_delta" not in names
    assert names.count("program") == 1 and names.count("match") == 1


# ---- the driver ---------------------------------------------------------------------


def test_torch_driver_never_calls_eval_program(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("TorchDriver called vexpr.eval_program")

    monkeypatch.setattr(tv, "eval_program", refuse)
    tdev.reset_launches()
    client = tsyn.build_driver(6, 240, device="cpu")
    oracle = tsyn.build_oracle(6, 240)
    resp, totals = client.audit_capped(20)
    assert resp.results()
    assert set(tsyn.audit_result_sig(resp.results())) <= set(
        tsyn.audit_result_sig(oracle.audit().results()))
    pods = tsyn.make_pods(4, seed=3, violation_rate=1.0)
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"no-ir-{i}"
    got = [[r.msg for r in x.results()] for x in client.review_batch(pods)]
    want = [[r.msg for r in x.results()] for x in oracle.review_batch(pods)]
    assert got == want and any(got)
    assert all(v == 0 for v in tdev.launches.values())


def test_program_eval_takes_the_plain_version_on_the_cpu():
    cols, params, elems, tables, _rv, _t = _env_arrays(1)
    tenv = tv.EvalEnv(state_from_numpy(
        {k: v for k, v in cols.items() if k != KEYS}, "cpu"),
        *group_params_from_numpy([(params, elems, tables)], "cpu")[0],
        {KEYS: torch.from_numpy(cols[KEYS]["ids"])}, C, R, "cpu")
    prog = tv.VProgram(STRPRED_CASES["review_scalar"](tv), [], [], [])
    mask = torch.ones((C + 3, R), dtype=torch.bool)
    mask[0] = False
    group = bind_group(progcode.encode(prog), tenv, 1)
    tdev.reset_launches()
    got = program_eval(mask.clone(), [group])
    want = program_eval_plain(mask.clone(), [group])
    assert torch.equal(got, want)
    assert not got[0].any() and got[C + 1:].all()  # rows outside the group
    assert tdev.launches["program"] == 0
