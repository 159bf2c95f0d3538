"""VExpr: the vectorized predicate IR for violation rules, evaluated in
PyTorch.

A template's violation rules compile (ops/vectorizer.py) into a VProgram:
clauses OR-ed over [C, R] (C constraints of the template's kind, R
resources), each clause an AND of conditions, optionally reduced over a slot
axis S (one flattened array-iteration) and/or a constraint-parameter axis P.

Soundness contract: a program may OVER-approximate the true violation
predicate (false positives are filtered by the host-side interpreter render)
but must never under-approximate.  Conditions whose exact value cannot be
computed on device resolve to a compile-time `unknown_default` chosen by
polarity: True in positive positions, False under negation.

Cross-type comparisons follow OPA's total order via type-code ranks
(null < bool < number < string < composites), making </==/etc exact for
every case the corpus produces.  Numbers compare in float64, as the host
columns hold them (ops/columns.py) and as the interpreter compares.

The IR dataclasses are the JAX package's (gatekeeper_tpu/ops/vexpr.py), so
``VProgram.structure_key()`` is byte-equal between the two.  The
evaluators run on torch tensors on ``EvalEnv.device``; string predicates
(StrPred) go through the CUDA kernel K2, set counts (SetCountCmp) through
K3 and join lookups (JoinCmp) through K8 on the card, and through their
plain versions on the CPU.  ``eval_program`` is the port's counterpart of
the JAX function, which the tests hold it to; TorchDriver evaluates the
same programs through their bytecode (ops/progcode.py, ops/program.py:
kernel K9), and shares ``join_counts`` with it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from .columns import T_COMP, T_FALSE, T_NUM, T_STR, T_TRUE, T_UNDEF
from .interning import Interner
from .joinkernel import UNKNOWN_KEY
from .joinlookup import join_lookup, join_lookup_many
from .setcount import setcount
from .strpred import strpred

# ---- operands -------------------------------------------------------------


@dataclass(frozen=True)
class ColRef:
    """A scalar [R] or slot [R, S] column."""

    colkey: Tuple
    slot: bool


@dataclass(frozen=True)
class ParamRef:
    """Per-constraint scalar parameter [C]."""

    ppath: Tuple[str, ...]


@dataclass(frozen=True)
class ParamElemRef:
    """Per-element field of the active AnyParam axis [C, P]."""

    ppath: Tuple[str, ...]
    subpath: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Lit:
    value: Any


Operand = Union[ColRef, ParamRef, ParamElemRef, Lit]

# ---- nodes ----------------------------------------------------------------


@dataclass(frozen=True)
class Const:
    value: bool


@dataclass(frozen=True)
class Truthy:
    operand: Operand
    negate: bool = False


@dataclass(frozen=True)
class Cmp:
    op: str  # == != < <= > >=
    lhs: Operand
    rhs: Operand
    unknown_default: bool = True


@dataclass(frozen=True)
class StrPred:
    """pred(col_string, rhs_string): startswith/endswith/contains/re_match
    (re_match: rhs is the pattern).  Evaluated via host-precomputed lookup
    tables over the vocabulary; `pred_id` keys the table set in the env."""

    pred: str
    operand: Operand  # the string column tested
    rhs: Operand  # ParamRef/ParamElemRef/Lit supplying the pattern/affix
    pred_id: int = -1
    negate: bool = False


@dataclass(frozen=True)
class AnyParam:
    """Exists over a parameter-array axis."""

    ppath: Tuple[str, ...]
    inner: Tuple[Any, ...]  # conjunction over [C, P(, R, S)]


@dataclass(frozen=True)
class SetCountCmp:
    """count(left - right) <op> n over id sets."""

    left: Tuple[str, Any]  # ("keyset", colkey) | ("paramids", ppath)
    right: Tuple[str, Any]
    op: str
    n: int


@dataclass(frozen=True)
class JoinCmp:
    """Cross-resource aggregate comparison (ops/joinkernel.py): the
    distinct-provider-row count at the row's interned join key, compared
    to ``rhs`` under the engine's exact total order.  ``plan_id`` indexes
    the program's ``join_plans``.  Without a join binding on the EvalEnv
    (the admission/review path and the numpy host tier, where no global
    inventory is resident) the node resolves to ``unknown_default`` —
    over-approximation, filtered by the interpreter render."""

    plan_id: int
    op: str  # == != < <= > >=
    rhs: Operand
    slot: bool = False
    unknown_default: bool = True
    # duplicate detection: subtract the local row's OWN provider
    # contribution (1 when the row participates in the aggregate) so
    # "another object has my key" is exact whether or not the evaluated
    # row is itself a provider — requires local and remote key columns
    # to coincide (enforced by the classifier)
    exclude_self: bool = False


@dataclass(frozen=True)
class AnySlots:
    inner: Tuple[Any, ...]  # conjunction, may reference slot columns


@dataclass(frozen=True)
class ReduceSlots:
    """any over a slot axis of (inner conjunction & slot mask), producing a
    resource-level value — used when an inlined helper clause iterates an
    array while the enclosing violation clause does not."""

    inner: Tuple[Any, ...]
    iter_key: Tuple


@dataclass(frozen=True)
class BoolOp:
    """Generic combinators for inlined helper disjunctions: op in
    {'and', 'or', 'not'}.  'not' is STATEMENT negation: true when the child
    statement fails (false or undefined) — children already encode
    undefined-as-False, so plain logical negation is correct."""

    op: str
    children: Tuple[Any, ...]


VNode = Union[
    Const, Truthy, Cmp, StrPred, AnyParam, SetCountCmp, JoinCmp, AnySlots,
    BoolOp, ReduceSlots,
]


@dataclass
class Clause:
    conds: Tuple[VNode, ...]
    slot_iter: Optional[Tuple] = None  # iteration group key, if any


@dataclass
class VProgram:
    clauses: List[Clause]
    column_specs: List  # ColumnSpec list
    param_scalars: List[Tuple[str, ...]]
    param_arrays: List[Tuple[Tuple[str, ...], Tuple[Tuple[str, ...], ...]]]
    # (ppath, needed elem subpaths)
    str_preds: List[StrPred] = field(default_factory=list)
    literals: List[str] = field(default_factory=list)
    exact: bool = True
    # classified cross-resource aggregates (ops/joinkernel.py JoinPlan),
    # indexed by JoinCmp.plan_id; () for row-local programs
    join_plans: Tuple = ()
    # per-clause compiled violation-object (message) plans, parallel to
    # `clauses` (ops/renderplan.py); None entries render via the
    # interpreter.  Deliberately NOT part of structure_key: message
    # literals never affect the traced device computation.
    clause_plans: Optional[Tuple] = None

    def structure_key(self) -> str:
        """Template-clone batching key: programs with identical structure
        (same clauses/columns/param layout, parameters varying per
        constraint) evaluate together on one constraint axis — so N clones
        of a template family cost one traced subgraph, not N.  Memoized:
        the IR is immutable after vectorize()."""
        key = getattr(self, "_structure_key", None)
        if key is None:
            sig = (
                [(c.conds, c.slot_iter) for c in self.clauses],
                sorted(s.key for s in self.column_specs),
                self.param_scalars,
                self.param_arrays,
                self.literals,
            )
            if self.join_plans:
                # appended only when present so row-local programs keep
                # their pre-referential keys (warm AOT caches survive)
                sig = sig + (self.join_plans,)
            key = repr(sig)
            self._structure_key = key
        return key




# ---- evaluation -----------------------------------------------------------


class EvalEnv:
    """Bound tensors for one (constraint batch, resource batch) evaluation.

    cols:    colkey -> {tcode[R(,S)] int8, sid int32, num float64, mask?}
    params:  ppath -> {tcode[C], sid, num}
    elems:   (ppath, subpath) -> {tcode[C,P], sid, num, mask[C,P]}
    tables:  pred_id -> (tableT [vocab, U] uint8, idx [C] or [C, P] int32)
             — the predicate tables TRANSPOSED from the host's [U, vocab]
             (convert.group_params_from_numpy), so one string id's U bytes
             are contiguous
    keysets: colkey -> ids [R, K] int32
    """

    def __init__(self, cols, params, elems, tables, keysets, C, R, device):
        self.cols = cols
        self.params = params
        self.elems = elems
        self.tables = tables
        self.keysets = keysets
        self.C = C
        self.R = R
        self.device = torch.device(device)
        # cross-resource join binding (ops/joinkernel.py JoinBinding), set
        # by the driver for audit sweeps; None on the review path, where
        # every JoinCmp resolves to its polarity's unknown_default — a
        # sound over-approximation the render filters
        self.joins = None
        self._consts: Dict[Tuple, torch.Tensor] = {}

    def const(self, value, dtype: torch.dtype) -> torch.Tensor:
        """A 0-d tensor on the env's device, made once per evaluation."""
        key = (value, dtype)
        t = self._consts.get(key)
        if t is None:
            t = torch.tensor(value, dtype=dtype, device=self.device)
            self._consts[key] = t
        return t


def _operand_arrays(op: Operand, env: EvalEnv, axes: str, pidx=None):
    """Return dict with tcode/sid/num tensors broadcastable to `axes`
    ('CR' or 'CRS').  Inside an AnyParam unroll, `pidx` selects the current
    parameter element (ParamElemRef tensors are [C, P])."""

    def shape_col(x, slot):
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
            x = v[..., None]  # [C, 1]
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
            x = v[:, pidx][:, None]  # [C, 1]
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
                "tcode": d["tcode"][0],
                "sid": d["sid"][0],
                "num": env.const(0.0, torch.float64),
            }
        if isinstance(v, bool):
            return {
                "tcode": env.const(T_TRUE if v else T_FALSE, torch.int8),
                "sid": env.const(-1, torch.int32),
                "num": env.const(0.0, torch.float64),
            }
        if isinstance(v, (int, float)):
            return {
                "tcode": env.const(T_NUM, torch.int8),
                "sid": env.const(-1, torch.int32),
                "num": env.const(float(v), torch.float64),
            }
        raise ValueError(f"unsupported literal {v!r}")
    raise TypeError(op)


def _eval_node(node: VNode, env: EvalEnv, axes: str, pidx=None):
    if isinstance(node, Const):
        return env.const(bool(node.value), torch.bool)
    if isinstance(node, Truthy):
        d = _operand_arrays(node.operand, env, axes, pidx)
        truthy = (d["tcode"] != T_UNDEF) & (d["tcode"] != T_FALSE)
        return ~truthy if node.negate else truthy
    if isinstance(node, Cmp):
        a = _operand_arrays(node.lhs, env, axes, pidx)
        b = _operand_arrays(node.rhs, env, axes, pidx)
        return _cmp_values(a, b, node.op, node.unknown_default, env)
    if isinstance(node, StrPred):
        return _eval_strpred(node, env, axes, pidx)
    if isinstance(node, AnyParam):
        # unroll the parameter axis: peak transient stays at [C, R(, S)]
        mask = env.elems[(node.ppath, ())]["mask"]  # [C, P]
        acc = None
        for p in range(mask.shape[1]):
            part = mask[:, p][:, None]
            if axes.endswith("S"):
                part = part[..., None]
            for n in node.inner:
                part = part & _eval_node(n, env, axes, pidx=p)
            acc = part if acc is None else (acc | part)
        return acc if acc is not None else env.const(False, torch.bool)
    if isinstance(node, SetCountCmp):
        return _eval_setcount(node, env)
    if isinstance(node, JoinCmp):
        return _eval_joincmp(node, env, axes, pidx)
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
        return torch.any(acc, dim=-1)
    if isinstance(node, AnySlots):
        raise ValueError("AnySlots must be handled at clause level")
    raise TypeError(node)


def _rank(tcode):
    """tcode -> OPA order rank: [-1, 0, 1, 1, 2, 3, 4] for tcodes 0..6
    (undefined, null, false, true, number, string, composite), clipped
    like the JAX package's table lookup."""
    t = tcode.clamp(0, 6)
    return t - 1 - (t >= T_TRUE).to(t.dtype)


def _cmp_values(a, b, op: str, unknown_default: bool, env: EvalEnv):
    at, bt = a["tcode"], b["tcode"]
    ra, rb = _rank(at), _rank(bt)
    defined = (at != T_UNDEF) & (bt != T_UNDEF)
    both_comp = (at == T_COMP) & (bt == T_COMP)
    unk = env.const(bool(unknown_default), torch.bool)

    same_rank = ra == rb
    # per-rank equality (composite unknown)
    eq_val = torch.where(
        at == T_NUM, a["num"] == b["num"],
        torch.where(at == T_STR, a["sid"] == b["sid"], at == bt),
    )
    eq = same_rank & eq_val & (at == bt)

    if op in ("==", "!="):
        res = eq if op == "==" else defined & ~eq
        return torch.where(both_comp, unk, defined & res)

    # ordering: rank decides across types; within rank use value
    lt_val = torch.where(
        at == T_NUM, a["num"] < b["num"],
        # bools: false < true; string < string is unknown (below)
        (at == T_FALSE) & (bt == T_TRUE),
    )
    lt = torch.where(same_rank, lt_val, ra < rb)
    unknown = both_comp | (same_rank & (at == T_STR))
    if op == "<":
        res = lt
    elif op == ">":
        res = ~lt & ~eq
    elif op == "<=":
        res = lt | eq
    else:  # >=
        res = ~lt
    return torch.where(unknown, unk, defined & res)


def _eval_strpred(node: StrPred, env: EvalEnv, axes: str, pidx=None):
    tableT, idx = env.tables[node.pred_id]  # [vocab, U], [C] or [C, P]
    d = _operand_arrays(node.operand, env, axes, pidx)
    sid, tcode = d["sid"], d["tcode"]
    if idx.dim() == 2:  # per param element
        if pidx is None:
            raise ValueError("per-element StrPred outside AnyParam")
        idx = idx[:, pidx]
    if sid.shape[0] == 1:
        # review-side operand ([1, R(, S)], the hot case): kernel K2
        return strpred(
            tableT, idx.contiguous(), tcode.contiguous(), sid.contiguous(),
            node.negate,
        )
    # constraint-side operand (tiny [C, 1(, 1)]): plain gather
    idx_b = idx[:, None]
    if axes.endswith("S"):
        idx_b = idx_b[..., None]
    sidc = sid.clamp(0, tableT.shape[0] - 1)
    hit = tableT[sidc.long(), idx_b.long()] != 0
    res = (tcode == T_STR) & (sid >= 0) & hit
    return ~res if node.negate else res


def _eval_joincmp(node: JoinCmp, env: EvalEnv, axes: str, pidx=None):
    """Distinct-provider-rows-per-key aggregate vs ``rhs``: the table
    lookup less the row's own contribution (kernel K8), then the exact
    cross-type comparison.  Key-undefined cells (missing field) compare
    as undefined, exactly like the interpreter's failed assignment;
    UNKNOWN_KEY cells (unnormalizable values) resolve to the polarity
    default so the render filter decides.  Counts compare in float64,
    exact for any count."""
    jb = env.joins
    unk = env.const(bool(node.unknown_default), torch.bool)
    if jb is None:
        return unk
    plan = jb.plans[node.plan_id]
    q = env.cols[plan.local_colkey]["sid"][None]  # [1, R] or [1, R, S]
    counts = join_counts(env, node.plan_id, node.exclude_self)[None]
    if not plan.local_slot and axes.endswith("S"):
        q, counts = q[..., None], counts[..., None]
    lhs = {
        "tcode": torch.where(q >= 0, env.const(T_NUM, torch.int8),
                             env.const(T_UNDEF, torch.int8)),
        "sid": env.const(-1, torch.int32),
        "num": counts.to(torch.float64),
    }
    rhs = _operand_arrays(node.rhs, env, axes, pidx)
    res = _cmp_values(lhs, rhs, node.op, node.unknown_default, env)
    return torch.where(q == UNKNOWN_KEY, unk, res)


def _join_lookup_args(env: EvalEnv, plan_id: int, exclude_self: bool):
    """The cache key of a (plan, exclude_self) lookup, and its table,
    dense counts, queries and scope."""
    jb = env.joins
    plan = jb.plans[plan_id]
    uk, uc, dense = jb.table(plan_id, env)
    sid = env.cols[plan.local_colkey]["sid"]
    scope = jb.self_scope(plan_id) if exclude_self else None
    return ("counts", plan, bool(exclude_self)), uk, uc, dense, sid, scope


def join_counts(env: EvalEnv, plan_id: int, exclude_self: bool):
    """int32 counts in the shape of the plan's local key column ([R] or
    [R, S]): the table lookup (kernel K8, reading the table's dense
    counts where K7 built them), less the row's own contribution
    with ``exclude_self``.  A count depends on the row, not the
    constraint, so it is looked up once per (plan, exclude_self) and
    evaluation, in the binding's cache that every group shares, by
    fill_join_counts: here on a miss, or for every group at once before
    the groups are bound."""
    jb = env.joins
    key = ("counts", jb.plans[plan_id], bool(exclude_self))
    if key not in jb.cache:
        fill_join_counts([(env, plan_id, exclude_self)])
    return jb.cache[key]


def fill_join_counts(needs) -> None:
    """The lookups of ``needs``, each (env, plan_id, exclude_self) of one
    evaluation, into the bindings' caches, where join_counts reads them:
    each (plan, exclude_self) not in its cache, once.  A lookup into a
    table with dense counts (K7's, a full sweep's) is dense mode's launch
    of its own (join_lookup); the rest, into the host join index's tables
    (a delta sweep's), run together in one table-mode K8 launch
    (join_lookup_many)."""
    todo = {}
    for env, plan_id, exclude_self in needs:
        jb = env.joins
        key = ("counts", jb.plans[plan_id], bool(exclude_self))
        if key in jb.cache or (id(jb.cache), key) in todo:
            continue
        key, uk, uc, dense, sid, scope = _join_lookup_args(env, plan_id,
                                                           exclude_self)
        if dense is not None:
            jb.cache[key] = join_lookup(uk, uc, sid, scope, dense=dense)
        else:
            todo[(id(jb.cache), key)] = (jb.cache, key,
                                         (uk, uc, sid, scope))
    if not todo:
        return
    counts = join_lookup_many([args for _c, _k, args in todo.values()])
    for (cache, key, _args), hit in zip(todo.values(), counts):
        cache[key] = hit


_SETCOUNT_OPS = {">": 0, ">=": 1, "<": 2, "<=": 3, "==": 4, "!=": 5}


def _eval_setcount(node: SetCountCmp, env: EvalEnv):
    """count(left - right) <op> n, parameters [C, P] against a keyset
    [R, K] either way round: kernel K3."""

    def side(ref):
        kind, key = ref
        if kind == "keyset":
            return env.keysets[key], None, "R"
        # key is (ppath, subpath)
        return env.elems[key]["sid"], env.elems[key]["mask"], "C"

    lids, lmask, lax = side(node.left)
    rids, rmask, rax = side(node.right)
    if lax == "C" and rax == "R":
        cids, cmask, kids, orient = lids, lmask, rids, 0
    elif lax == "R" and rax == "C":
        cids, cmask, kids, orient = rids, rmask, lids, 1
    else:
        raise ValueError("unsupported SetCountCmp side combination")
    return setcount(
        cids.contiguous(), cmask.contiguous(), kids.contiguous(), orient,
        _SETCOUNT_OPS[node.op], node.n, Interner.PAD,
    )


def _slot_mask(env: EvalEnv, iter_key: Tuple):
    for spec_key, arrs in env.cols.items():
        if "mask" in arrs and spec_key[1] == iter_key:
            return arrs["mask"]
    raise ValueError("no slot column for iteration group")


def eval_program(prog: VProgram, env: EvalEnv):
    """-> bool[C, R]: OR over clauses."""
    shape = (env.C, env.R)
    total = torch.zeros(shape, dtype=torch.bool, device=env.device)
    for clause in prog.clauses:
        r_conds: List = []
        s_conds: List = []
        for cond in clause.conds:
            if _clause_uses_slot(cond):
                s_conds.append(cond)
            else:
                r_conds.append(cond)
        acc = torch.ones(shape, dtype=torch.bool, device=env.device)
        for cond in r_conds:
            acc = acc & _eval_node(cond, env, "CR")
        if clause.slot_iter is not None:
            sacc = _slot_mask(env, clause.slot_iter)[None, :, :]  # [1, R, S]
            for cond in s_conds:
                sacc = sacc & _eval_node(cond, env, "CRS")
            acc = acc & torch.any(sacc, dim=2)
        elif s_conds:
            raise ValueError("slot conditions without slot_iter")
        total = total | acc
    return total


def _clause_uses_slot(node: VNode) -> bool:
    if isinstance(node, JoinCmp):
        return node.slot
    if isinstance(node, Truthy):
        return isinstance(node.operand, ColRef) and node.operand.slot
    if isinstance(node, Cmp):
        return any(
            isinstance(o, ColRef) and o.slot for o in (node.lhs, node.rhs)
        )
    if isinstance(node, StrPred):
        return isinstance(node.operand, ColRef) and node.operand.slot
    if isinstance(node, AnyParam):
        return any(_clause_uses_slot(n) for n in node.inner)
    if isinstance(node, BoolOp):
        return any(_clause_uses_slot(n) for n in node.children)
    return False
