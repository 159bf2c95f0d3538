"""The port's numpy evaluation (ops/npeval.py) bit-equal to the JAX
package's numpy tier: ``match_kernel`` against gatekeeper_tpu's
``match_kernel(xp=np)`` on the seeded match corpus
(util/matchcorpus.py: selectors live, every namespaceSelector mode, and
constraints without selectors, the host fast path), and ``eval_program``
against gatekeeper_tpu's ``eval_program(EvalEnv(xp=np))`` on the seeded
single-node environments of tests/test_torch_program.py: every node kind,
every comparison across the seven type codes, string predicates on both
sides and per parameter element, set counts both ways round, parameter
axes of P = 0 and 1, slot reductions and slot clauses, JoinCmp unbound
(its polarity default: the review tiers bind no inventory), and the same
refusals.  Every output is bool: tolerance 0."""

import random

import numpy as np
import pytest

from gatekeeper_tpu.ops import matchkernel as jmk
from gatekeeper_tpu.ops import pack as jpack
from gatekeeper_tpu.ops import vexpr as jv
from gatekeeper_tpu.ops.interning import Interner as JInterner
from gatekeeper_tpu_torch.ops import npeval
from gatekeeper_tpu_torch.ops import pack as tpack
from gatekeeper_tpu_torch.ops import vexpr as tv
from gatekeeper_tpu_torch.ops.interning import Interner as TInterner
from gatekeeper_tpu_torch.util.matchcorpus import (
    NAMESPACES,
    make_corpus,
    make_review,
)

from .test_torch_program import (
    C,
    ITER,
    ITER2,
    KEYS,
    OPS,
    REFUSED,
    SCALAR,
    SCALAR2,
    SLOT,
    SLOT2,
    STRPRED_CASES,
    R,
    _env_arrays,
)

# ---- the match ----------------------------------------------------------------


def _matches(constraints, reviews):
    """(JAX numpy tier, port numpy tier) on the same dicts, each packed by
    its own package."""
    cached = NAMESPACES.get
    j_int, t_int = JInterner(), TInterner()
    j_rv = jpack.pack_reviews(reviews, j_int, cached,
                              bucket_rows=False).arrays
    j_cs = jpack.pack_constraints(constraints, j_int).arrays
    t_rv = tpack.pack_reviews(reviews, t_int, cached,
                              bucket_rows=False).arrays
    t_cs = tpack.pack_constraints(constraints, t_int).arrays
    want = jmk.match_kernel(j_rv, j_cs, xp=np)
    got = npeval.match_kernel(t_rv, t_cs)
    return [np.asarray(a) for a in want], got


@pytest.mark.parametrize("seed", range(6))
def test_match_bit_equal_to_the_jax_numpy_tier(seed):
    constraints, reviews = make_corpus(seed, 24, 40)
    (jm, ja), (tm, ta) = _matches(constraints, reviews)
    assert tm.dtype == np.bool_ and tm.shape == jm.shape
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ta, ja)
    assert tm.any() and not tm.all() and ta.any()


@pytest.mark.parametrize("nssel", [False, True])
def test_match_without_selectors_takes_the_fast_path(nssel):
    """Constraints without a labelSelector skip the selector algebra (and
    without a namespaceSelector its modes): the result is the same."""
    constraints = [
        {"kind": "K", "metadata": {"name": "plain"}, "spec": {}},
        {"kind": "K", "metadata": {"name": "pods"}, "spec": {"match": {
            "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}}},
        {"kind": "K", "metadata": {"name": "nsd"}, "spec": {"match": {
            "namespaces": ["ns-1", "ns-2"], "scope": "Namespaced"}}},
    ]
    if nssel:
        constraints.append({"kind": "K", "metadata": {"name": "sel"},
                            "spec": {"match": {"namespaceSelector": {
                                "matchLabels": {"env": "prod"}}}}})
    rng = random.Random(9)
    reviews = [make_review(rng, i) for i in range(16)]
    (jm, ja), (tm, ta) = _matches(constraints, reviews)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ta, ja)
    assert tm.any()


# ---- the violation programs -------------------------------------------------


def _evals(make_clauses, seed, P_=2):
    """(JAX eval_program under EvalEnv(xp=np), npeval.eval_program) of one
    program on one seeded environment of host arrays."""
    cols, params, elems, tables, _rv, _t = _env_arrays(seed, P_)
    vals = {k: v for k, v in cols.items() if k != KEYS}
    keysets = {KEYS: cols[KEYS]["ids"]}
    jenv = jv.EvalEnv(vals, params, elems, tables, keysets, C, R, xp=np)
    tenv = npeval.EvalEnv(vals, params, elems, tables, keysets, C, R)
    want = np.asarray(jv.eval_program(
        jv.VProgram(make_clauses(jv), [], [], []), jenv))
    got = npeval.eval_program(tv.VProgram(make_clauses(tv), [], [], []), tenv)
    return want, got


def _cmp_cases(op, unk):
    return [
        lambda m: [m.Clause((m.Cmp(op, m.ColRef(SCALAR, False),
                                   m.ParamRef(("p",)),
                                   unknown_default=unk),))],
        lambda m: [
            m.Clause((m.Cmp(op, m.ColRef(SLOT, True), m.Lit(0.5),
                            unknown_default=unk),), slot_iter=ITER),
            m.Clause((m.Cmp(op, m.ColRef(SCALAR2, False), m.Lit("x"),
                            unknown_default=unk),
                      m.Cmp(op, m.Lit(True), m.ColRef(SCALAR, False)))),
        ],
        lambda m: [m.Clause((m.AnyParam(("arr",), (
            m.Cmp(op, m.ParamElemRef(("arr",), ("sub",)),
                  m.ColRef(SLOT, True), unknown_default=unk),)),),
            slot_iter=ITER)],
    ]


def _inner(m):
    return (m.Cmp("==", m.ParamElemRef(("arr",)), m.ColRef(SCALAR, False),
                  unknown_default=False),
            m.Truthy(m.ParamElemRef(("arr",), ("sub",))))


CASES = {
    **{f"cmp{op}_{unk}_{i}": case
       for op in OPS for unk in (True, False)
       for i, case in enumerate(_cmp_cases(op, unk))},
    "truthy_const_boolops": lambda m: [
        m.Clause((m.Truthy(m.ColRef(SCALAR, False)),
                  m.BoolOp("not", (m.Truthy(m.ParamRef(("q",))),)))),
        m.Clause((m.BoolOp("or", (
            m.Truthy(m.ColRef(SCALAR2, False), negate=True),
            m.BoolOp("and", (m.Const(True), m.Truthy(m.ParamRef(("p",))))),
            m.Const(False))),)),
    ],
    "const_false_and_empty_clause": lambda m: [
        m.Clause((m.Const(False),)), m.Clause(())],
    "no_clauses": lambda m: [],
    **{f"strpred_{k}": v for k, v in STRPRED_CASES.items()},
    **{f"setcount{op}_{orient}": (
        lambda m, op=op, lr=lr: [m.Clause((m.SetCountCmp(*lr, op, 1),))])
       for op in OPS
       for orient, lr in (
           ("params_minus_keys", (("paramids", (("arr",), ())),
                                  ("keyset", KEYS))),
           ("keys_minus_params", (("keyset", KEYS),
                                  ("paramids", (("arr",), ())))))},
    "anyparam": lambda m: [m.Clause((m.AnyParam(("arr",), _inner(m)),))],
    "anyparam_negated": lambda m: [m.Clause((
        m.BoolOp("not", (m.AnyParam(("arr",), _inner(m)),)),
        m.Truthy(m.ColRef(SCALAR, False))))],
    "reduce_slots_and_slot_clauses": lambda m: [
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
    ],
    **{f"joincmp_unbound_{op}": (lambda m, op=op: [
        m.Clause((m.JoinCmp(0, op, m.Lit(1)),
                  m.Truthy(m.ColRef(SCALAR2, False)))),
        m.Clause((m.JoinCmp(0, op, m.ParamRef(("p",)),
                            unknown_default=False, exclude_self=True),)),
        m.Clause((m.JoinCmp(1, op, m.Lit(2), slot=True),
                  m.Truthy(m.ColRef(SCALAR, False))), slot_iter=ITER2),
    ]) for op in OPS},
}


@pytest.mark.parametrize("P_", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_program_bit_equal_to_the_jax_numpy_tier(case, P_):
    for seed in range(3):
        want, got = _evals(CASES[case], seed, P_)
        assert got.dtype == np.bool_ and got.shape == (C, R)
        np.testing.assert_array_equal(got, want)


def test_the_seeded_programs_reach_both_outcomes():
    seen = set()
    for case in CASES.values():
        seen.update(np.unique(_evals(case, 0)[1]).tolist())
    assert seen == {False, True}


@pytest.mark.parametrize("msg", sorted(REFUSED))
def test_program_refuses_what_the_jax_tier_refuses(msg):
    with pytest.raises(ValueError, match=msg):
        _evals(lambda m: REFUSED[msg](m) if m is jv else [], 0)
    with pytest.raises(ValueError, match=msg):
        _evals(lambda m: [] if m is jv else REFUSED[msg](m), 0)
