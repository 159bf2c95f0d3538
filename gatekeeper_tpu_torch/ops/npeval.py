"""The numpy evaluation of the host serving tier (ops/npside.py).

The constraint match (ops/matchkernel.py's algebra) and the violation
programs of the IR (ops/vexpr.py) over the host's packed arrays, in numpy:
no tensor, no launch, no upload.  It is the JAX package's numpy tier, its
``match_kernel(xp=np)`` and ``eval_program(EvalEnv(xp=np))``, with the
array namespace fixed to numpy, and adds no semantics of its own: the same
over-approximating mask, filtered by the same exact render.

The arrays are the host's: pack.py's match arrays, columns.py's columns,
params.py's parameters and its predicate tables as [U, vocab] uint8 (the
device path transposes them).  Numbers compare in float64, as the columns
and parameters hold them.  A JoinCmp resolves to its polarity's
unknown_default: an admission review has no resident inventory to join
against, on this tier as on the device's review path.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .columns import T_COMP, T_FALSE, T_NUM, T_STR, T_TRUE, T_UNDEF
from .interning import Interner
from .pack import PAD, SCOPE_NONE, UNDEF, WILD
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
    _clause_uses_slot,
)

# ---- the match ----------------------------------------------------------------


def _selector_match(lab_pairs, cs_ml, cs_op, cs_key, cs_vals, cs_nvals):
    """matches_label_selector over [R, L, 2] labels x [C, ...] selectors
    -> bool[C, R], the small static widths unrolled so no transient
    exceeds [C, R]."""
    lab_key = lab_pairs[:, :, 0]  # [R, L]
    lab_val = lab_pairs[:, :, 1]
    lab_ok = lab_key != PAD
    L = lab_key.shape[1]

    def key_val_hit(k, v):  # k, v: [C, 1] -> any label slot matches both
        acc = np.zeros((k.shape[0], lab_key.shape[0]), bool)
        for l in range(L):
            acc = acc | (
                (lab_key[None, :, l] == k) & (lab_val[None, :, l] == v)
                & lab_ok[None, :, l]
            )
        return acc

    def key_hit(k):  # [C, 1] -> any label slot has this key
        acc = np.zeros((k.shape[0], lab_key.shape[0]), bool)
        for l in range(L):
            acc = acc | ((lab_key[None, :, l] == k) & lab_ok[None, :, l])
        return acc

    C = cs_ml.shape[0]
    R = lab_key.shape[0]

    # matchLabels: every (k, v) pair (non-pad) must be satisfied
    ml_ok = np.ones((C, R), bool)
    for i in range(cs_ml.shape[1]):
        k = cs_ml[:, i, 0][:, None]
        v = cs_ml[:, i, 1][:, None]
        ml_ok = ml_ok & (key_val_hit(k, v) | (k == PAD))

    # matchExpressions
    ex_ok = np.ones((C, R), bool)
    for e in range(cs_op.shape[1]):
        op = cs_op[:, e][:, None]  # [C, 1]
        key = cs_key[:, e][:, None]
        has = key_hit(key)
        val_in = np.zeros((C, R), bool)
        for v in range(cs_vals.shape[2]):
            val_in = val_in | key_val_hit(key, cs_vals[:, e, v][:, None])
        nvals = cs_nvals[:, e][:, None]
        violated = np.where(
            op == 0, ~has | ((nvals > 0) & ~val_in),  # In
            np.where(
                op == 1, has & (nvals > 0) & val_in,  # NotIn
                np.where(
                    op == 2, ~has,  # Exists
                    np.where(op == 3, has, False),  # DoesNotExist / unknown
                ),
            ),
        )
        ex_ok = ex_ok & ~(violated & (op != -1))
    return ml_ok & ex_ok


def _any_labelselector_match(rv, cs_ml, cs_op, cs_key, cs_vals, cs_nvals):
    """any_labelselector_match (target_template_source.go:233-278)."""
    args = (cs_ml, cs_op, cs_key, cs_vals, cs_nvals)
    sm_obj = _selector_match(rv["obj_labels"], *args)
    sm_old = _selector_match(rv["old_labels"], *args)
    empty = np.full_like(rv["obj_labels"][:1], PAD)
    sm_empty = _selector_match(empty, *args)  # [C, 1]
    obj_e = rv["obj_empty"][None, :]
    old_e = rv["old_empty"][None, :]
    return np.where(
        obj_e & old_e, sm_empty,
        np.where(old_e, sm_obj, np.where(obj_e, sm_old, sm_obj | sm_old)),
    )


def _no_selectors(ml, op) -> bool:
    """True when every row's selector is empty (all-PAD matchLabels, no
    matchExpressions), the common cluster shape: the selector algebra is
    then skipped."""
    return bool((ml[:, :, 0] == PAD).all() and (op == -1).all())


def match_kernel(rv: dict, cs: dict) -> Tuple[np.ndarray, np.ndarray]:
    """-> (match bool[C, R], autoreject bool[C, R])."""
    group = rv["group"][None, :]  # [1, R]
    kind = rv["kind"][None, :]
    C = cs["kind_pairs"].shape[0]
    R = group.shape[1]

    # kind selectors: any (group, kind) pair matches (KP unrolled)
    kinds_ok = np.zeros((C, R), bool)
    for p in range(cs["kind_pairs"].shape[1]):
        kp_g = cs["kind_pairs"][:, p, 0][:, None]  # [C, 1]
        kp_k = cs["kind_pairs"][:, p, 1][:, None]
        kinds_ok = kinds_ok | (
            ((kp_g == WILD) | (kp_g == group))
            & ((kp_k == WILD) | (kp_k == kind))
            & (kp_g != PAD)
        )

    # namespaces / excludedNamespaces (N unrolled)
    ns_name = rv["ns_name"][None, :]  # [1, R]
    ns_def = ns_name != UNDEF
    always = rv["always"][None, :]

    def member(ids):
        acc = np.zeros((C, R), bool)
        for i in range(ids.shape[1]):
            col = ids[:, i][:, None]
            acc = acc | ((col == ns_name) & (col != PAD))
        return acc

    ns_ok = ~cs["has_ns"][:, None] | always | (ns_def & member(cs["ns_ids"]))
    ex_ok = ~cs["has_ex"][:, None] | always | (ns_def & ~member(cs["ex_ids"]))

    scope = cs["scope"][:, None]  # [C, 1]
    ns_empty = rv["ns_empty"][None, :]
    scope_ok = np.where(
        (scope == SCOPE_NONE) | (scope == 1), True,
        np.where(
            scope == 2, ~ns_empty,
            np.where(scope == 3, ns_empty, False),  # SCOPE_OTHER -> False
        ),
    )

    # labelSelector: an empty selector matches everything, and clusters
    # overwhelmingly install constraints without selectors
    if _no_selectors(cs["ls_ml"], cs["ls_op"]):
        ls_ok = np.ones((C, R), bool)
    else:
        ls_ok = _any_labelselector_match(
            rv, cs["ls_ml"], cs["ls_op"], cs["ls_key"], cs["ls_vals"],
            cs["ls_nvals"],
        )

    # namespaceSelector by mode: 0 always-T, 1 ns labels, 2 uncached-F, 3 is_ns
    if not cs["has_nssel"].any():
        nssel_ok = np.ones((C, R), bool)
    else:
        sm_ns = _selector_match(
            rv["ns_labels"], cs["nssel_ml"], cs["ns_op"], cs["ns_key"],
            cs["ns_vals"], cs["ns_nvals"],
        )
        alm_ns = _any_labelselector_match(
            rv, cs["nssel_ml"], cs["ns_op"], cs["ns_key"], cs["ns_vals"],
            cs["ns_nvals"],
        )
        mode = rv["ns_mode"][None, :]
        nssel_result = np.where(
            mode == 0, True,
            np.where(mode == 1, sm_ns, np.where(mode == 3, alm_ns, False)),
        )
        nssel_ok = ~cs["has_nssel"][:, None] | nssel_result

    valid = cs["valid"][:, None] & rv["valid"][None, :]
    match = kinds_ok & ns_ok & ex_ok & scope_ok & ls_ok & nssel_ok & valid
    autoreject = cs["has_nssel"][:, None] & rv["autoreject"][None, :] & valid
    return match, autoreject


# ---- the violation programs ---------------------------------------------------

_RANK = np.array([-1, 0, 1, 1, 2, 3, 4], np.int8)  # tcode -> OPA order rank


class EvalEnv:
    """Bound host arrays for one (constraint batch, resource batch)
    evaluation.

    cols:    colkey -> {tcode[R(,S)], sid, num, mask?}
    params:  ppath -> {tcode[C], sid, num}
    elems:   (ppath, subpath) -> {tcode[C,P], sid, num, mask[C,P]}
    tables:  pred_id -> (table [U, vocab] uint8, idx [C] or [C, P])
    keysets: colkey -> ids [R, K]
    """

    def __init__(self, cols, params, elems, tables, keysets, C, R):
        self.cols = cols
        self.params = params
        self.elems = elems
        self.tables = tables
        self.keysets = keysets
        self.C = C
        self.R = R


def _operand_arrays(op, env: EvalEnv, axes: str, pidx=None):
    """Return dict with tcode/sid/num arrays broadcast to `axes` layout
    ('CR' or 'CRS').  Inside an AnyParam unroll, `pidx` selects the current
    parameter element (ParamElemRef arrays are [C, P])."""

    def shape_col(a, slot):
        x = np.asarray(a)  # [R] or [R, S]
        if slot and not axes.endswith("S"):
            raise ValueError("slot column outside slot context")
        x = x[None]
        if not slot and axes.endswith("S"):
            x = x[..., None]
        return x

    if isinstance(op, ColRef):
        d = env.cols[op.colkey]
        return {k: shape_col(v, op.slot) for k, v in d.items() if k != "mask"}
    if isinstance(op, ParamRef):
        out = {}
        for k, v in env.params[op.ppath].items():
            x = np.asarray(v)[..., None]  # [C, 1]
            if axes.endswith("S"):
                x = x[..., None]
            out[k] = x
        return out
    if isinstance(op, ParamElemRef):
        if pidx is None:
            raise ValueError("ParamElemRef outside AnyParam")
        out = {}
        for k, v in env.elems[(op.ppath, op.subpath)].items():
            if k == "mask":
                continue
            x = np.asarray(v)[:, pidx][:, None]  # [C, 1]
            if axes.endswith("S"):
                x = x[..., None]
            out[k] = x
        return out
    if isinstance(op, Lit):
        v = op.value
        if isinstance(v, str):
            # literal string ids are interned at pack time into env.params
            # under the pseudo-path ("__lit__", v); [1]-shaped scalars
            d = env.params[("__lit__", v)]
            return {
                "tcode": np.asarray(d["tcode"])[0],
                "sid": np.asarray(d["sid"])[0],
                "num": np.asarray(0.0),
            }
        if isinstance(v, bool):
            return {
                "tcode": np.asarray(T_TRUE if v else T_FALSE, np.int8),
                "sid": np.asarray(-1, np.int32),
                "num": np.asarray(0.0),
            }
        if isinstance(v, (int, float)):
            return {
                "tcode": np.asarray(T_NUM, np.int8),
                "sid": np.asarray(-1, np.int32),
                "num": np.asarray(float(v)),
            }
        raise ValueError(f"unsupported literal {v!r}")
    raise TypeError(op)


def _eval_node(node, env: EvalEnv, axes: str, pidx=None):
    if isinstance(node, Const):
        return np.asarray(node.value)
    if isinstance(node, Truthy):
        d = _operand_arrays(node.operand, env, axes, pidx)
        truthy = (d["tcode"] != T_UNDEF) & (d["tcode"] != T_FALSE)
        return ~truthy if node.negate else truthy
    if isinstance(node, Cmp):
        a = _operand_arrays(node.lhs, env, axes, pidx)
        b = _operand_arrays(node.rhs, env, axes, pidx)
        return _cmp_values(a, b, node.op, node.unknown_default)
    if isinstance(node, StrPred):
        return _eval_strpred(node, env, axes, pidx)
    if isinstance(node, AnyParam):
        # unroll the parameter axis: peak transient stays at [C, R(, S)]
        mask = np.asarray(env.elems[(node.ppath, ())]["mask"])  # [C, P]
        acc = None
        for p in range(mask.shape[1]):
            part = mask[:, p][:, None]
            if axes.endswith("S"):
                part = part[..., None]
            for n in node.inner:
                part = part & _eval_node(n, env, axes, pidx=p)
            acc = part if acc is None else (acc | part)
        return acc if acc is not None else np.asarray(False)
    if isinstance(node, SetCountCmp):
        return _eval_setcount(node, env)
    if isinstance(node, JoinCmp):
        # no inventory is bound on the review tiers: the polarity default
        return np.asarray(node.unknown_default)
    if isinstance(node, BoolOp):
        parts = [_eval_node(c, env, axes, pidx) for c in node.children]
        if node.op == "not":
            return ~parts[0]
        acc = parts[0]
        for p in parts[1:]:
            acc = (acc & p) if node.op == "and" else (acc | p)
        return acc
    if isinstance(node, ReduceSlots):
        if axes.endswith("S"):
            raise ValueError("nested slot reduction is not supported")
        acc = _slot_mask(env, node.iter_key)[None]  # [1, R, S]
        for n in node.inner:
            acc = acc & _eval_node(n, env, axes + "S", pidx)
        return np.any(acc, axis=-1)
    if isinstance(node, AnySlots):
        raise ValueError("AnySlots must be handled at clause level")
    raise TypeError(node)


def _cmp_values(a, b, op: str, unknown_default: bool):
    ra = _RANK[np.clip(a["tcode"], 0, 6)]
    rb = _RANK[np.clip(b["tcode"], 0, 6)]
    defined = (a["tcode"] != T_UNDEF) & (b["tcode"] != T_UNDEF)
    both_comp = (a["tcode"] == T_COMP) & (b["tcode"] == T_COMP)

    same_rank = ra == rb
    # per-rank equality (composite unknown)
    eq_val = np.where(
        a["tcode"] == T_NUM, a["num"] == b["num"],
        np.where(
            a["tcode"] == T_STR, a["sid"] == b["sid"],
            a["tcode"] == b["tcode"],  # null/bools: tcode equality decides
        ),
    )
    eq = same_rank & eq_val & (a["tcode"] == b["tcode"])

    if op in ("==", "!="):
        res = eq if op == "==" else defined & ~eq
        return np.where(both_comp, unknown_default, defined & res)

    # ordering: rank decides across types; within rank use value
    lt_val = np.where(
        a["tcode"] == T_NUM, a["num"] < b["num"],
        np.where(
            a["tcode"] == T_STR, False,  # string<string: unknown
            (a["tcode"] == T_FALSE) & (b["tcode"] == T_TRUE),
        ),
    )
    lt = np.where(same_rank, lt_val, ra < rb)
    unknown = both_comp | (same_rank & (a["tcode"] == T_STR))
    if op == "<":
        res = lt
    elif op == ">":
        res = ~lt & ~eq
    elif op == "<=":
        res = lt | eq
    else:  # >=
        res = ~lt
    return np.where(unknown, unknown_default, defined & res)


def _eval_strpred(node: StrPred, env: EvalEnv, axes: str, pidx=None):
    """The host-precomputed table's byte at (the constraint's row, the
    string id): the batch is admission-sized, so the broadcast gather is
    the fast form."""
    table, idx = env.tables[node.pred_id]  # [U, vocab], [C] or [C, P]
    d = _operand_arrays(node.operand, env, axes, pidx)
    sid = d["sid"]
    idx = np.asarray(idx)
    if idx.ndim == 2:  # per param element
        if pidx is None:
            raise ValueError("per-element StrPred outside AnyParam")
        idx = idx[:, pidx]
    table = np.asarray(table)
    sidc = np.clip(sid, 0, table.shape[1] - 1)
    idx_b = idx[:, None]
    if axes.endswith("S"):
        idx_b = idx_b[..., None]
    hit = table[idx_b, sidc] != 0
    res = (d["tcode"] == T_STR) & (sid >= 0) & hit
    return ~res if node.negate else res


def _eval_setcount(node: SetCountCmp, env: EvalEnv):
    def side(ref):
        kind, key = ref
        if kind == "keyset":
            ids = np.asarray(env.keysets[key])  # [R, K]
            return ids, ids != Interner.PAD, "R"
        # key is (ppath, subpath)
        ids = np.asarray(env.elems[key]["sid"])  # [C, P]
        return ids, np.asarray(env.elems[key]["mask"]), "C"

    lids, lmask, lax = side(node.left)
    rids, rmask, rax = side(node.right)

    # count elements of `left` missing from `right`, the small static
    # widths (P parameter elements, K keyset slots) unrolled so transients
    # stay at [C, R]
    if lax == "C" and rax == "R":
        C, P = lids.shape
        R, K = rids.shape
        cnt = np.zeros((C, R), np.int32)
        for p in range(P):
            lid = lids[:, p][:, None]  # [C, 1]
            inr = np.zeros((C, R), bool)
            for k in range(K):
                inr = inr | ((lid == rids[None, :, k]) & rmask[None, :, k])
            cnt = cnt + (lmask[:, p][:, None] & ~inr)
    elif lax == "R" and rax == "C":
        R, K = lids.shape
        C, P = rids.shape
        cnt = np.zeros((C, R), np.int32)
        for k in range(K):
            lid = lids[None, :, k]  # [1, R]
            inr = np.zeros((C, R), bool)
            for p in range(P):
                inr = inr | ((lid == rids[:, p][:, None])
                             & rmask[:, p][:, None])
            cnt = cnt + (lmask[None, :, k] & ~inr)
    else:
        raise ValueError("unsupported SetCountCmp side combination")

    n = node.n
    return {
        ">": cnt > n, ">=": cnt >= n, "<": cnt < n,
        "<=": cnt <= n, "==": cnt == n, "!=": cnt != n,
    }[node.op]


def _slot_mask(env: EvalEnv, iter_key: Tuple):
    for spec_key, arrs in env.cols.items():
        if "mask" in arrs and spec_key[1] == iter_key:
            return np.asarray(arrs["mask"])
    raise ValueError("no slot column for iteration group")


def eval_program(prog: VProgram, env: EvalEnv) -> np.ndarray:
    """-> bool[C, R]: OR over clauses."""
    total = np.zeros((env.C, env.R), bool)
    for clause in prog.clauses:
        r_conds: List = []
        s_conds: List = []
        for cond in clause.conds:
            if _clause_uses_slot(cond):
                s_conds.append(cond)
            else:
                r_conds.append(cond)
        acc = np.ones((env.C, env.R), bool)
        for cond in r_conds:
            acc = acc & _eval_node(cond, env, "CR")
        if clause.slot_iter is not None:
            sacc = _slot_mask(env, clause.slot_iter)[None, :, :]  # [1, R, S]
            for cond in s_conds:
                sacc = sacc & _eval_node(cond, env, "CRS")
            acc = acc & np.any(sacc, axis=2)
        elif s_conds:
            raise ValueError("slot conditions without slot_iter")
        total = total | acc
    return total
