"""Incremental host-serving constraint side: numpy-mode fused evaluation.

The admission-sized serving path.  The device (XLA) fused executable is
the throughput path — audits, streaming, big batches — but behind a
network relay a single-review dispatch costs a full RTT, and during a
template-ingest storm every epoch bump forces a constraint-side repack
(~tens of ms at 500 templates) plus, on structure changes, an XLA
retrace (seconds).  The reference never degrades under ingest (ms-scale
compile budget, pkg/controller/constrainttemplate/stats_reporter.go:33-37),
so neither may we.

This module keeps a SECOND packed constraint side that is:

- evaluated in numpy (EvalEnv(xp=np) + match_kernel(xp=np)): the same
  VExpr IR and match algebra as the device path — identical soundness
  contract (over-approximate mask, exact interpreter render) — with no
  trace, no compile, and no device round-trip.  At C=500, R<=8 a serve
  is ~1-3 ms of numpy.
- maintained INCREMENTALLY from the driver's constraint-side change log:
  one added/updated/removed constraint costs one single-row pack merged
  into growing per-group buffers, O(1) in the number of installed
  templates.  A mid-storm admission review therefore never pays a full
  repack, let alone a compile.

Group layout mirrors the device side: constraints batch by program
STRUCTURE (vexpr.VProgram.structure_key), so a template clone lands in
an existing group and evaluates through the same program node walk.
Constraints without a vectorized program evaluate match-only (their
mask over-approximates to the match, and the exact render filters).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .columns import T_UNDEF, extract_columns
from .interning import Interner
from .npeval import EvalEnv, eval_program, match_kernel
from .pack import PAD, pack_constraints, pack_reviews
from .params import pack_params

# pad values for growing each match-side buffer (axis>=1 widening and
# new rows): must equal what pack_constraints writes into padding
_CS_PAD = {
    "kind_pairs": PAD,
    "has_ns": False,
    "ns_ids": PAD,
    "has_ex": False,
    "ex_ids": PAD,
    "scope": 0,
    "valid": False,
    "ls_ml": PAD,
    "ls_op": -1,
    "ls_key": PAD,
    "ls_vals": PAD,
    "ls_nvals": 0,
    "has_nssel": False,
    "nssel_ml": PAD,
    "ns_op": -1,
    "ns_key": PAD,
    "ns_vals": PAD,
    "ns_nvals": 0,
}

_MATCH_ONLY = "__match_only__"


def _bucket(n: int, minimum: int = 1) -> int:
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


def _grow_to(arr: np.ndarray, shape: Tuple[int, ...], pad) -> np.ndarray:
    """Return an array of at least `shape` (bucketed per axis) containing
    `arr` at the origin and `pad` elsewhere."""
    target = tuple(
        _bucket(max(a, s)) for a, s in zip(arr.shape, shape)
    )
    if target == arr.shape:
        return arr
    out = np.full(target, pad, arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def _write_row(buf: np.ndarray, row: int, src: np.ndarray, pad) -> np.ndarray:
    """Assign src[0] (a 1-row packed array) into buf[row], widening buf's
    trailing axes as needed; returns (possibly reallocated) buf."""
    need = (row + 1,) + src.shape[1:]
    buf = _grow_to(buf, need, pad)
    if src.ndim == 1:
        buf[row] = src[0]
        return buf
    # clear the row to pad first: the incoming row may be narrower than
    # the buffer (e.g. fewer kind pairs than the widest constraint)
    buf[row] = pad
    buf[(row,) + tuple(slice(0, s) for s in src.shape[1:])] = src[0]
    return buf


class _Group:
    """One structure group: growing [cap, ...] buffers + row assignment."""

    def __init__(self, prog):
        self.prog = prog  # None for match-only
        self.names: List[Optional[Tuple[str, str]]] = []
        self.rowof: Dict[Tuple[str, str], int] = {}
        self.free: List[int] = []
        self.cs: Optional[Dict[str, np.ndarray]] = None
        # program-side buffers (None when prog is None)
        self.params: Dict[Tuple, Dict[str, np.ndarray]] = {}
        self.lits: Dict[Tuple, Dict[str, np.ndarray]] = {}
        self.elems: Dict[Tuple, Dict[str, np.ndarray]] = {}
        # pred_id -> [mat [U,vocab] uint8, idx [cap(,P)] int32]
        self.tables: Dict[int, list] = {}
        self.stacks: Dict[int, Dict[Tuple[str, str], int]] = {}
        self.table_vocab = 0  # real (unpadded) vocab the mats cover

    def nrows(self) -> int:
        return len(self.names)

    def _alloc_row(self) -> int:
        if self.free:
            return self.free.pop()
        self.names.append(None)
        return len(self.names) - 1

    def add(self, kind: str, name: str, constraint: dict,
            interner: Interner, pred_cache) -> None:
        row = self._alloc_row()
        self.names[row] = (kind, name)
        self.rowof[(kind, name)] = row

        cp1 = pack_constraints([constraint], interner)
        if self.cs is None:
            self.cs = {}
            for k, a in cp1.arrays.items():
                self.cs[k] = a.copy()
            # row 0 written by construction
        else:
            for k, a in cp1.arrays.items():
                self.cs[k] = _write_row(self.cs[k], row, a, _CS_PAD[k])

        if self.prog is None:
            return
        meta: dict = {}
        p1, e1, t1 = pack_params(
            [constraint], self.prog, interner, pred_cache, 1, meta_out=meta
        )
        for ppath, enc in p1.items():
            if ppath and ppath[0] == "__lit__":
                self.lits[ppath] = enc  # structure-constant, shared
                continue
            dst = self.params.setdefault(ppath, {})
            for k, a in enc.items():
                pad = self._scalar_pad(k)
                buf = dst.get(k)
                if buf is None:
                    buf = np.full(1, pad, a.dtype)
                dst[k] = _write_row(buf, row, a, pad)
        for ekey, enc in e1.items():
            dst = self.elems.get(ekey)
            if dst is None:
                self.elems[ekey] = {k: a.copy() for k, a in enc.items()}
                continue
            for k, a in enc.items():
                dst[k] = _write_row(dst[k], row, a, self._scalar_pad(k))
        self._merge_tables(t1, meta.get("stacks", {}), row, interner,
                           pred_cache)

    @staticmethod
    def _scalar_pad(field: str):
        if field == "tcode":
            return T_UNDEF
        if field == "sid":
            return Interner.MISSING
        if field == "mask":
            return False
        return 0  # num

    def _merge_tables(self, t1, stacks, row, interner, pred_cache):
        from .params import _PRED_FNS  # noqa: F401 (documents provenance)

        vocab = interner.snapshot_size()
        for pred_id, (mat1, idx1) in t1.items():
            stack1 = stacks.get(pred_id, {})
            entry = self.tables.get(pred_id)
            if entry is None:
                gstack: Dict[Tuple[str, str], int] = {}
                gmat = np.zeros((1, _bucket(vocab, 256)), np.uint8)
                gidx = np.zeros((1,) + idx1.shape[1:], np.int32)
                self.tables[pred_id] = entry = [gmat, gidx]
                self.stacks[pred_id] = gstack
            else:
                gstack = self.stacks[pred_id]
            gmat, gidx = entry
            # map local table rows -> global rows (0 stays the all-false row)
            remap = {0: 0}
            for key, lrow in stack1.items():
                grow_ = gstack.get(key)
                if grow_ is None:
                    grow_ = len(gstack) + 1
                    gstack[key] = grow_
                    if grow_ >= gmat.shape[0]:
                        gmat = _grow_to(
                            gmat, (grow_ + 1, gmat.shape[1]), 0
                        )
                    dense = pred_cache[key].dense()
                    n = min(len(dense), gmat.shape[1])
                    gmat[grow_, :n] = dense[:n]
                remap[lrow] = grow_
            idx_mapped = np.vectorize(
                lambda v: remap.get(int(v), 0), otypes=[np.int32]
            )(idx1) if idx1.size else idx1.astype(np.int32)
            gidx = _write_row(gidx, row, idx_mapped, 0)
            entry[0], entry[1] = gmat, gidx
        # NOT resetting table_vocab: freshly-added rows were filled from
        # dense() up to the CURRENT vocab (>= table_vocab), and existing
        # rows still cover table_vocab — the next refresh_tables pass
        # extends everything from there.  Resetting to 0 here made every
        # mid-storm serve rewrite all mats (an O(stack x vocab) tax).

    def remove(self, kind: str, name: str) -> bool:
        row = self.rowof.pop((kind, name), None)
        if row is None:
            return False
        self.names[row] = None
        self.free.append(row)
        if self.cs is not None and row < len(self.cs["valid"]):
            self.cs["valid"][row] = False
        return True

    def refresh_tables(self, interner: Interner, pred_cache) -> None:
        """Extend predicate mats to cover the current vocabulary (reviews
        intern new strings; PredicateTable grows incrementally)."""
        vocab = interner.snapshot_size()
        if vocab <= self.table_vocab:
            return
        for pred_id, entry in self.tables.items():
            gmat = entry[0]
            if vocab > gmat.shape[1]:
                gmat = _grow_to(gmat, (gmat.shape[0], vocab), 0)
                entry[0] = gmat
            for key, grow_ in self.stacks[pred_id].items():
                dense = pred_cache[key].dense()
                n = min(len(dense), gmat.shape[1])
                gmat[grow_, self.table_vocab:n] = dense[self.table_vocab:n]
        self.table_vocab = vocab

    def eval(self, rv_arrays, cols, R: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mask [cap, R], autoreject [cap, R]) numpy bools."""
        match, autoreject = match_kernel(rv_arrays, self.cs)
        if self.prog is None:
            return match, autoreject
        cap = len(self.cs["valid"])
        keysets = {
            spec.key: cols[spec.key]["ids"]
            for spec in self.prog.column_specs
            if spec.kind == "keyset"
        }
        prog_cols = {
            spec.key: cols[spec.key]
            for spec in self.prog.column_specs
            if spec.kind != "keyset"
        }
        params = dict(self.params)
        params.update(self.lits)
        env = EvalEnv(
            prog_cols, params,
            {k: self._padded_elems(v, cap) for k, v in self.elems.items()},
            {pid: (e[0], self._pad_rows(e[1], cap, 0))
             for pid, e in self.tables.items()},
            keysets, cap, R,
        )
        return match & eval_program(self.prog, env), autoreject

    def _padded_elems(self, enc, cap):
        return {
            k: self._pad_rows(a, cap, self._scalar_pad(k))
            for k, a in enc.items()
        }

    def _pad_rows(self, a, cap, pad):
        if a.shape[0] >= cap:
            return a
        return _grow_to(a, (cap,) + a.shape[1:], pad)


class NpSide:
    """The incrementally-maintained host constraint side for one driver."""

    def __init__(self):
        self.groups: Dict[str, _Group] = {}
        self.loc: Dict[Tuple[str, str], str] = {}  # (kind, name) -> group key
        self.kind_group: Dict[str, str] = {}  # kind -> group key used
        self.last_epoch = -1
        self._union_specs: Optional[list] = None
        # per-epoch gather plan: [(group, out_positions, group_rows)] so
        # mask assembly is one fancy-index per group, not an O(C) Python
        # row-copy loop per review
        self._gather: Optional[Tuple[int, list]] = None

    # -- sync ----------------------------------------------------------------

    def sync(self, driver) -> None:
        """Bring the side up to date with the driver's constraint state by
        consuming the change log (caller holds the driver lock)."""
        if driver._cs_epoch == self.last_epoch:
            return
        if self.last_epoch < driver._cs_log_floor:
            self._rebuild(driver)
            return
        for epoch, kind, name in driver._cs_change_log:
            if epoch <= self.last_epoch:
                continue
            if name is None:
                self._apply_kind(driver, kind)
            else:
                self._apply_one(driver, kind, name)
        self.last_epoch = driver._cs_epoch

    def _rebuild(self, driver) -> None:
        self.groups.clear()
        self.loc.clear()
        self.kind_group.clear()
        self._union_specs = None
        for kind, by_name in driver.constraints.items():
            for name in by_name:
                self._apply_one(driver, kind, name)
        self.last_epoch = driver._cs_epoch

    def _group_key(self, driver, kind: str) -> str:
        prog = driver.programs.get(kind)
        return prog.structure_key() if prog else _MATCH_ONLY

    def _apply_kind(self, driver, kind: str) -> None:
        """Template-level change: the program (and so the group) may have
        changed — re-home every constraint of the kind."""
        for (k, n) in [key for key in self.loc if key[0] == kind]:
            self._remove(k, n)
        for name in driver.constraints.get(kind, {}):
            self._add(driver, kind, name)

    def _apply_one(self, driver, kind: str, name: str) -> None:
        cur = driver.constraints.get(kind, {}).get(name)
        self._remove(kind, name)
        if cur is not None:
            self._add(driver, kind, name)

    def _add(self, driver, kind: str, name: str) -> None:
        constraint = driver.constraints[kind][name]
        gkey = self._group_key(driver, kind)
        g = self.groups.get(gkey)
        if g is None:
            prog = driver.programs.get(kind)
            g = self.groups[gkey] = _Group(prog if gkey != _MATCH_ONLY
                                           else None)
            self._union_specs = None
        g.add(kind, name, constraint, driver.interner, driver.pred_cache)
        self.loc[(kind, name)] = gkey

    def _remove(self, kind: str, name: str) -> None:
        gkey = self.loc.pop((kind, name), None)
        if gkey is None:
            return
        g = self.groups.get(gkey)
        if g is not None:
            g.remove(kind, name)
            if not g.rowof:
                del self.groups[gkey]
                self._union_specs = None

    # -- serve ---------------------------------------------------------------

    def union_specs(self) -> list:
        if self._union_specs is None:
            seen = {}
            for g in self.groups.values():
                if g.prog is None:
                    continue
                for spec in g.prog.column_specs:
                    seen.setdefault(spec.key, spec)
            self._union_specs = list(seen.values())
        return self._union_specs

    def serve(self, driver, reviews: List[dict]):
        """-> (ordered, mask [C, R], autoreject [C, R]) with rows in
        sorted (kind, name) order — the compute_masks contract — or None
        when the side has nothing installed.  Caller holds the lock."""
        if not self.loc:
            return None
        rp = pack_reviews(
            reviews, driver.interner, driver.store.cached_namespace,
            bucket_rows=False,
        )
        R = len(rp.arrays["valid"])
        cols = extract_columns(
            reviews, self.union_specs(), driver.interner, R
        )
        # AFTER column extraction: extract_columns is what interns the
        # program-side strings (images, label values, ...); the predicate
        # mats must cover every id the gather below can see
        for g in self.groups.values():
            g.refresh_tables(driver.interner, driver.pred_cache)
        ordered = driver._ordered_constraints()
        C = len(ordered)
        plan = self._gather
        if plan is None or plan[0] != driver._cs_epoch:
            by_group: Dict[str, Tuple[list, list]] = {}
            for i, (kind, name, _c) in enumerate(ordered):
                gkey = self.loc.get((kind, name))
                if gkey is None:
                    continue  # sync raced a mutation; treat as no-match
                pos, rows_ = by_group.setdefault(gkey, ([], []))
                pos.append(i)
                rows_.append(self.groups[gkey].rowof[(kind, name)])
            plan = (driver._cs_epoch, [
                (gkey, np.asarray(pos, np.intp), np.asarray(rows_, np.intp))
                for gkey, (pos, rows_) in by_group.items()
            ])
            self._gather = plan
        mask = np.zeros((C, R), bool)
        rej = np.zeros((C, R), bool)
        for gkey, pos, rows_ in plan[1]:
            gm, gr = self.groups[gkey].eval(rp.arrays, cols, R)
            mask[pos] = gm[rows_, :R]
            rej[pos] = gr[rows_, :R]
        return ordered, mask, rej
