"""Referential policies: the cross-resource join/aggregate kernel subsystem.

Every workload before this module was row-local: a cell's verdict depended
only on (constraint, resource).  Gatekeeper's real capability surface also
includes constraints that need data *across* rows — unique ingress hosts,
required owner references, quota-by-label — which templates express by
iterating ``data.inventory``.  The interpreter answers those exactly but at
O(inventory) per evaluated cell, so a referential audit sweep is O(R^2).

This module keeps referential templates inside the vectorized sweep:

- ``classify_join_clause`` (called from ops/vectorizer.py) pattern-matches a
  violation clause against three referential plan families —
  duplicate-key detection (unique ingress host), existence-of-referenced-row
  (required storage class), and count/group-by vs a parameter quota — and
  compiles it to a :class:`JoinPlan` + a ``JoinCmp`` IR node
  (ops/vexpr.py) instead of bailing to the interpreter.
- all three families reduce to ONE aggregate: **distinct provider rows per
  interned join key**.  Key values are normalized type-tagged strings
  (:func:`normalize_join_key`) interned into the global vocabulary, so
  int-vs-str label values can never coerce into one group (the engine's
  ``values_equal`` is type-strict; the packed path must be too).
- the per-key table is built on the card inside the full audit sweep by
  kernel K7 (ops/joinkeys.py: in-row dedup of slot keys and a count per
  interned key id, no sort, kept as a dense [vocab] array beside the
  table), and each JoinCmp's per-cell count is one load from those dense
  counts minus the row's own contribution, kernel K8 (ops/joinlookup.py;
  a binary search into the host index's tables in a delta sweep), then
  the engine's exact total-order comparison.
  The plain torch and numpy versions of both live here.  Under a mesh
  each shard's slab builds its own table and K7's merge sums the shards'
  counts per key (``provider_key_table`` with ``axis_name``).
- :class:`JoinState` is the host-side join-group index (key -> provider
  rows, key -> reader rows) that gives the delta sweep O(churn) dispatch:
  a churned row invalidates only its key group (old keys + new keys), and
  only those readers re-evaluate / re-render; its (uk, uc) tables feed
  the delta sweep's lookups.

Soundness: a JoinCmp in the REVIEW path (admission batches — no inventory
on the device) resolves to its polarity's ``unknown_default`` and the
interpreter render filters, exactly like an unclassified template.  On the
AUDIT path the plan is exact modulo one documented corner (two inventory
objects of the same kind/namespace/name under different groupVersions count
as two provider rows where the reference's ``identical`` helper sees one) —
over-approximation only, filtered by the interpreter render.

Divergence assertion (GK_JOIN_ASSERT=1, disabled by GK_BUG_COMPAT=1): a
cell an exact join plan flagged whose interpreter render comes back empty
raises :class:`JoinDivergence` — the fuzz-oracle posture of docs/parity.md
applied to the referential tier.  See docs/referential.md.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .interning import Interner

#: in-trace sentinel for "no key at this position": sorts past every real
#: interned id, so sort-based kernels compact invalid entries to the tail
KEY_INVALID = np.int32(2**31 - 1)

#: packed-column sentinel for a PRESENT key value the normalizer cannot
#: represent faithfully (NaN-bearing values: NaN != NaN under values_equal,
#: but any table key would equal itself).  JoinCmp resolves these cells to
#: the polarity's unknown_default — over-approximation, interpreter-exact.
UNKNOWN_KEY = -5

#: minimum padded width of a (uk, uc) key table
TABLE_MIN = 8

# ONE power-of-two bucketing helper repo-wide: joinkey slot widths
# (columns.py) and delta-table widths must stay consistent with the
# executables' shape buckets, so they share the same implementation
from .columns import _bucket as _pow2_bucket  # noqa: E402


# ---------------------------------------------------------------------------
# Key normalization (the interned-key contract)
# ---------------------------------------------------------------------------


def normalize_join_key(v: Any) -> Optional[str]:
    """Canonical type-tagged string for a JSON value used as a join key,
    or None when the value cannot be normalized faithfully (NaN anywhere).

    Injective over the engine's ``values_equal`` equivalence classes:
    two values normalize to the same string iff the interpreter oracle
    would consider them equal — ``5`` and ``5.0`` share ``n:5`` (numbers
    compare by value), but ``5`` / ``"5"`` / ``true`` stay distinct
    (type-strict equality, engine/value.py).  The packed path and any
    host-side oracle twin MUST share this one function; a second
    normalization is how int-vs-str label coercion bugs are born."""
    if isinstance(v, str):
        return "s:" + v
    if isinstance(v, bool):
        return "b:1" if v else "b:0"
    if isinstance(v, (int, float)):
        if isinstance(v, float):
            if v != v:  # NaN: self-unequal, no faithful table key exists
                return None
            if v.is_integer():
                v = int(v)
        return "n:" + repr(v)
    if v is None:
        return "z:"
    # composite (dict/list): canonical JSON — sorted keys, no whitespace,
    # and NESTED numbers canonicalized like the scalar branch (the
    # interpreter pools {"a": 5} with {"a": 5.0}; json.dumps alone would
    # split them into two keys and the aggregate would UNDER-approximate).
    # allow_nan=False so a nested NaN degrades to UNKNOWN instead of
    # producing a self-equal key the oracle would never match.
    try:
        return "j:" + json.dumps(
            _canon_numbers(v), sort_keys=True, separators=(",", ":"),
            allow_nan=False,
        )
    except (TypeError, ValueError):
        return None


def _canon_numbers(v: Any):
    """Recursively collapse int-valued floats to ints (the engine's
    numeric equality classes) inside a composite key value."""
    if isinstance(v, bool):
        return v
    if isinstance(v, float) and v == v and v.is_integer():
        return int(v)
    if isinstance(v, list):
        return [_canon_numbers(x) for x in v]
    if isinstance(v, tuple):
        return [_canon_numbers(x) for x in v]
    if isinstance(v, dict):
        return {k: _canon_numbers(x) for k, x in v.items()}
    return v


def intern_join_key(v: Any, interner: Interner) -> int:
    """Packed-column id for one extracted key value (ops/columns.py)."""
    norm = normalize_join_key(v)
    if norm is None:
        return UNKNOWN_KEY
    return interner.intern(norm)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class JoinPlan:
    """One classified cross-resource aggregate.

    ``agg`` names the family for observability ('dup' | 'exists' |
    'count'); the aggregate itself is always *distinct provider rows per
    key*.  ``local_colkey`` / ``remote_colkey`` are joinkey
    ColumnSpec.key tuples (ops/columns.py); providers are the inventory
    rows of ``remote_kind`` in ``remote_scope`` ('namespace' | 'cluster')
    whose remote key column yields the key."""

    agg: str
    local_colkey: Tuple
    local_slot: bool
    remote_scope: str
    remote_kind: str
    remote_colkey: Tuple
    remote_slot: bool

    @property
    def sig(self) -> str:
        """Stable identity for snapshot drift checks and dedup."""
        return repr((
            self.agg, self.local_colkey, self.local_slot,
            self.remote_scope, self.remote_kind,
            self.remote_colkey, self.remote_slot,
        ))


# ---------------------------------------------------------------------------
# Key tables and their lookup (the plain versions of kernels K7 and K8)
# ---------------------------------------------------------------------------


def _scatter_add(n: int, idx, w, xp):
    if xp is np:
        tot = np.zeros(n, np.int64)
        np.add.at(tot, idx, w)
        return tot
    return torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx.long(), w.long()
    )


def compact_key_table(keys, weights, xp):
    """Sort + segment-reduce group-by: ``(keys [N], weights [N])`` ->
    ``(uk [N], uc [N])`` where uk holds each distinct valid key once
    (ascending, KEY_INVALID-padded tail) and uc its summed weight.

    ``xp`` is numpy or torch.  The segment reduce is the classic
    sorted-run trick: sort, mark run starts, scatter-add weights per run
    id.  On the card, kernel K7 (ops/joinkeys.py) computes the same
    table without a sort."""
    n = keys.shape[0]
    if xp is np:
        order = np.argsort(keys)
        sk = keys[order]
        w = weights[order]
        first = np.concatenate([np.ones(1, bool), sk[1:] != sk[:-1]])
        run = np.cumsum(first.astype(np.int32)) - 1
        tot = _scatter_add(n, run, w, np)
        valid = sk != KEY_INVALID
        uk = np.where(first & valid, sk, KEY_INVALID)
        uc = np.where(first & valid, tot[run], 0)
        o2 = np.argsort(uk)
        return uk[o2], uc[o2].astype(np.int32)
    if n == 0:
        return keys.clone(), torch.zeros_like(keys)
    order = torch.argsort(keys)
    sk = keys[order]
    w = weights[order]
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = sk[1:] != sk[:-1]
    run = torch.cumsum(first, 0) - 1
    tot = _scatter_add(n, run, w, torch)
    keep = first & (sk != int(KEY_INVALID))
    uk = torch.where(keep, sk, torch.full_like(sk, int(KEY_INVALID)))
    uc = torch.where(keep, tot[run], torch.zeros_like(tot))
    o2 = torch.argsort(uk)
    return uk[o2], uc[o2].to(torch.int32)


def row_distinct_slot_keys(sid, mask, xp):
    """[R, S] slot key ids + validity mask -> flat [R*S] keys with each
    row's duplicate keys collapsed to one entry (a row providing the same
    host twice is ONE provider for that host — the reference's
    ``identical`` self-exclusion is object-level, not entry-level)."""
    if xp is np:
        s = np.where(mask, sid, KEY_INVALID)
        ss = np.sort(s, axis=1)
        keep = np.concatenate(
            [np.ones((ss.shape[0], 1), bool), ss[:, 1:] != ss[:, :-1]],
            axis=1,
        )
        return np.where(
            keep & (ss != KEY_INVALID), ss, KEY_INVALID
        ).reshape(-1)
    invalid = torch.full_like(sid, int(KEY_INVALID))
    ss = torch.sort(torch.where(mask, sid, invalid), dim=1).values
    keep = torch.ones_like(mask)
    keep[:, 1:] = ss[:, 1:] != ss[:, :-1]
    return torch.where(keep & (ss != int(KEY_INVALID)), ss, invalid).reshape(-1)


def participation(valid, kind, ns_empty, kind_id, namespaced: bool):
    """[R] bool: the rows that take part in a plan's aggregate — valid, of
    the plan's remote kind, in its scope (``namespaced``: a namespace;
    else none).  numpy or torch arrays."""
    return valid & (kind == kind_id) & (~ns_empty if namespaced else ns_empty)


def key_table(part, sid, mask, xp):
    """The distinct-provider-row table of one key column: ``sid`` [R]
    (``mask`` None) or [R, S] slot ids, rows ``part`` [R] taking part ->
    compact (uk, uc) of length R*S.  The plain version of kernel K7."""
    if mask is not None:
        flat = row_distinct_slot_keys(sid, mask & (sid >= 0) & part[:, None],
                                      xp)
    elif xp is np:
        flat = np.where(part & (sid >= 0), sid, KEY_INVALID)
    else:
        flat = torch.where(part & (sid >= 0), sid,
                           torch.full_like(sid, int(KEY_INVALID)))
    valid = flat != KEY_INVALID
    weights = valid.astype(np.int32) if xp is np else valid.to(torch.int32)
    return compact_key_table(flat, weights, xp)


def provider_key_table(plan: JoinPlan, kind_id, rv, cols, xp,
                       axis_name: Optional[str] = None,
                       vocab: Optional[int] = None):
    """The per-key distinct-provider-row table of ``plan`` from the
    resident columns (``xp`` numpy or torch): one segment-reduce over the
    full row axis.

    Under a mesh (``axis_name`` set, torch only) ``rv`` and ``cols`` are
    sequences of the shards' trees, in row order: each shard's slab
    builds its own table (kernel K7 on the card, ops/joinkeys.py), the
    tables are concatenated on the first shard's device and merged by
    their counts (K7's merge) — the JAX package's ``all_gather`` and
    second ``compact_key_table``, so a key whose providers span shards
    counts every provider row once.  ``vocab`` must then exceed every
    key id (the interner's size when the columns were packed), and the
    merge's dense counts come with the table: (uk, uc, dense)."""
    if axis_name is not None:
        from .joinkeys import join_keys, merge_key_tables

        if xp is not torch or vocab is None:
            raise ValueError("a mesh key table takes torch shards and vocab")
        first = rv[0]["valid"].device
        uks, ucs = [], []
        for srv, scols in zip(rv, cols):
            rcol = scols[plan.remote_colkey]
            uk, uc, _dense = join_keys(
                srv["valid"], srv["kind"], srv["ns_empty"], rcol["sid"],
                rcol["mask"] if plan.remote_slot else None, int(kind_id),
                plan.remote_scope == "namespace", int(vocab),
            )
            uks.append(uk.to(first))
            ucs.append(uc.to(first))
        return merge_key_tables(torch.cat(uks), torch.cat(ucs), int(vocab))
    part = participation(
        xp.asarray(rv["valid"]), xp.asarray(rv["kind"]),
        xp.asarray(rv["ns_empty"]), kind_id,
        plan.remote_scope == "namespace",
    )
    rcol = cols[plan.remote_colkey]
    mask = xp.asarray(rcol["mask"]) if plan.remote_slot else None
    return key_table(part, xp.asarray(rcol["sid"]), mask, xp)


def lookup_counts(uk, uc, q, xp):
    """Gather per-key counts at query ids ``q`` (any shape): one
    ``searchsorted`` into the compact table; absent or invalid keys
    answer 0.  On the card, kernel K8 (ops/joinlookup.py) does this
    lookup with a binary search per query, or with one load from K7's
    dense counts where the table has them."""
    n = uk.shape[0]
    if xp is np:
        i = np.clip(np.searchsorted(uk, q), 0, n - 1)
        found = (uk[i] == q) & (q >= 0)
        return np.where(found, uc[i], 0)
    if n == 0:
        return torch.zeros_like(q)
    i = torch.searchsorted(uk, q.contiguous()).clamp_(0, n - 1)
    found = (uk[i] == q) & (q >= 0)
    return torch.where(found, uc[i], torch.zeros_like(uc[i]))


def dense_counts(uk, uc, vocab: int):
    """The dense counts of a key table: ``uc`` scattered at ``uk``'s valid
    keys into int32 zeros [max(vocab, 1)] (torch).  The plain version of
    the array kernel K7 returns beside its table; every key must lie
    below ``vocab``."""
    dense = torch.zeros(max(vocab, 1), dtype=torch.int32, device=uk.device)
    keep = uk != int(KEY_INVALID)
    dense[uk[keep].long()] = uc[keep]
    return dense


class JoinBinding:
    """Per-evaluation join context attached to an EvalEnv (vexpr).

    mode 'trace':  tables are computed from the resident columns (full
                   audit sweeps, kernel K7 on the card); ``plan_args[i]``
                   carries the plan's remote ``kind_id`` and ``vocab``,
                   the interner's size when the sweep was packed (every
                   key id lies below it).
    mode 'tables': tables arrive as tensors (delta sweeps — the
                   dispatched rows are a churn slice, so the global
                   aggregate must come from the host join index; and a
                   mesh's full sweep, its shards' tables merged);
                   ``plan_args[i]`` holds ``uk``, ``uc`` and ``kind_id``,
                   and ``dense`` where K7's merge built the table.
    ``table`` returns (uk, uc, dense): dense the table's dense counts
    (ops/joinkeys.py) where K7 built it, None for the host index's.
    ``cache`` is shared across the sweep's program groups: 500 template
    clones of one referential family cost ONE table build."""

    __slots__ = ("mode", "plans", "plan_args", "rv", "cache")

    def __init__(self, mode: str, plans, plan_args, rv=None,
                 cache: Optional[dict] = None):
        self.mode = mode
        self.plans = plans
        self.plan_args = plan_args
        self.rv = rv
        self.cache = cache if cache is not None else {}

    def table(self, plan_id: int, env):
        plan = self.plans[plan_id]
        hit = self.cache.get(plan)
        if hit is None:
            arg = self.plan_args[plan_id]
            if self.mode == "tables":
                hit = (arg["uk"], arg["uc"], arg.get("dense"))
            else:
                from .joinkeys import join_keys

                rv = self.rv
                rcol = env.cols[plan.remote_colkey]
                hit = join_keys(
                    rv["valid"], rv["kind"], rv["ns_empty"], rcol["sid"],
                    rcol["mask"] if plan.remote_slot else None,
                    int(arg["kind_id"]), plan.remote_scope == "namespace",
                    int(arg["vocab"]),
                )
            self.cache[plan] = hit
        return hit

    def self_scope(self, plan_id: int):
        """What JoinCmp.exclude_self needs to tell whether a row takes
        part in the aggregate: (valid, kind, ns_empty, kind_id,
        namespaced).  Both modes carry the review arrays — delta
        dispatches slice them row-aligned with the columns."""
        plan = self.plans[plan_id]
        rv = self.rv
        return (rv["valid"], rv["kind"], rv["ns_empty"],
                int(self.plan_args[plan_id]["kind_id"]),
                plan.remote_scope == "namespace")


# ---------------------------------------------------------------------------
# Host-side join-group index (delta-sweep locality + table source)
# ---------------------------------------------------------------------------


def _pairs_for_side(plan: JoinPlan, colkey: Tuple, slot: bool, ap,
                    part: Optional[np.ndarray]) -> np.ndarray:
    """(row, key_sid) pairs for one side of a plan over the resident
    audit pack, distinct per row.  ``part`` masks participating rows
    (None = every valid row)."""
    col = ap.cols.get(colkey)
    if col is None:
        return np.empty((0, 2), np.int64)
    sid = np.asarray(col["sid"])
    if part is None:
        part = np.asarray(ap.rp["valid"])
    if slot:
        ok = np.asarray(col["mask"]) & (sid >= 0) & part[:, None]
        rows, slots = np.nonzero(ok)
        pairs = np.stack([rows, sid[rows, slots]], axis=1)
        if len(pairs):
            pairs = np.unique(pairs, axis=0)
        return pairs.astype(np.int64)
    rows = np.nonzero(part & (sid >= 0))[0]
    return np.stack([rows, sid[rows]], axis=1).astype(np.int64)


def _provider_part(plan: JoinPlan, ap, interner: Interner) -> np.ndarray:
    rp = ap.rp
    return participation(
        np.asarray(rp["valid"]), np.asarray(rp["kind"]),
        np.asarray(rp["ns_empty"]), interner.intern(plan.remote_kind),
        plan.remote_scope == "namespace",
    )


def _keys_of_row(plan, colkey, slot, ap, row, part_ok: bool) -> Tuple[int, ...]:
    if not part_ok:
        return ()
    col = ap.cols.get(colkey)
    if col is None:
        return ()
    sid = np.asarray(col["sid"])
    if slot:
        ok = np.asarray(col["mask"])[row] & (sid[row] >= 0)
        return tuple(sorted(set(int(s) for s in sid[row][ok])))
    s = int(sid[row])
    return (s,) if s >= 0 else ()


class JoinState:
    """The join-group index: per plan, key -> provider rows (drives the
    aggregate) and key -> reader rows (rows whose verdict/message reads
    that key's aggregate).  All access under the owning driver's lock.

    Full sweeps rebuild it (O(R) numpy grouping) and DIFF against the
    previous index: keys whose provider set changed have their readers'
    row generations bumped, so the render caches (driver._render_memo +
    the per-constraint render_cache) can never serve a message whose
    group aggregate moved underneath it.  Delta sweeps update it
    incrementally (O(churn)) and return the affected reader rows — the
    key-group locality contract ``tools/check_join_parity.py`` asserts."""

    def __init__(self, plans: Tuple[JoinPlan, ...], rebuild_gen: int):
        self.plans = tuple(plans)
        self.sig = tuple(p.sig for p in self.plans)
        self.rebuild_gen = rebuild_gen
        self.built = False
        n = len(self.plans)
        self.providers: List[Dict[int, set]] = [{} for _ in range(n)]
        self.readers: List[Dict[int, set]] = [{} for _ in range(n)]
        self.row_pkeys: List[Dict[int, Tuple[int, ...]]] = [
            {} for _ in range(n)
        ]
        self.row_rkeys: List[Dict[int, Tuple[int, ...]]] = [
            {} for _ in range(n)
        ]

    # ---- build / diff ------------------------------------------------------

    @staticmethod
    def _index(pairs: np.ndarray):
        by_key: Dict[int, set] = {}
        by_row: Dict[int, Tuple[int, ...]] = {}
        if len(pairs):
            order = np.lexsort((pairs[:, 1], pairs[:, 0]))
            pairs = pairs[order]
            rows = pairs[:, 0]
            starts = np.concatenate(
                [[0], np.nonzero(rows[1:] != rows[:-1])[0] + 1, [len(rows)]]
            )
            for a, b in zip(starts[:-1], starts[1:]):
                r = int(rows[a])
                ks = tuple(int(k) for k in pairs[a:b, 1])
                by_row[r] = ks
                for k in ks:
                    by_key.setdefault(k, set()).add(r)
        return by_key, by_row

    def rebuild(self, ap, interner: Interner) -> set:
        """Re-derive the index from the resident packed columns; returns
        the reader rows whose key group changed since the previous index
        (empty on first build — nothing was cached against it)."""
        bump: set = set()
        for i, plan in enumerate(self.plans):
            part = _provider_part(plan, ap, interner)
            prov_pairs = _pairs_for_side(
                plan, plan.remote_colkey, plan.remote_slot, ap, part
            )
            new_prov, new_rowp = self._index(prov_pairs)
            read_pairs = _pairs_for_side(
                plan, plan.local_colkey, plan.local_slot, ap, None
            )
            new_read, new_rowr = self._index(read_pairs)
            if self.built:
                old_prov, old_read = self.providers[i], self.readers[i]
                for k in set(old_prov) | set(new_prov):
                    if old_prov.get(k) != new_prov.get(k):
                        bump |= old_read.get(k, set())
                        bump |= new_read.get(k, set())
            self.providers[i] = new_prov
            self.readers[i] = new_read
            self.row_pkeys[i] = new_rowp
            self.row_rkeys[i] = new_rowr
        self.built = True
        return bump

    # ---- delta -------------------------------------------------------------

    def affected(self, ap, interner: Interner, dirty) -> set:
        """Reader rows (beyond the dirty set) whose key-group aggregate a
        churn batch changes — WITHOUT mutating the index (eligibility
        preview; ``commit`` applies)."""
        out: set = set()
        for i, plan in enumerate(self.plans):
            part = _provider_part(plan, ap, interner)
            changed: set = set()
            for r in dirty:
                old = set(self.row_pkeys[i].get(r, ()))
                new = set(_keys_of_row(
                    plan, plan.remote_colkey, plan.remote_slot, ap, r,
                    bool(part[r]),
                ))
                changed |= old ^ new
            readers = self.readers[i]
            for k in changed:
                out |= readers.get(k, set())
        return out - set(dirty)

    def commit(self, ap, interner: Interner, dirty) -> set:
        """Apply a churn batch to the index; returns the affected reader
        rows (beyond the dirty set) and bumps their pack row generations
        so stale rendered results cannot be reused."""
        out: set = set()
        dirty = set(dirty)
        for i, plan in enumerate(self.plans):
            part = _provider_part(plan, ap, interner)
            prov, read = self.providers[i], self.readers[i]
            rowp, rowr = self.row_pkeys[i], self.row_rkeys[i]
            changed: set = set()
            for r in dirty:
                old = set(rowp.get(r, ()))
                new = set(_keys_of_row(
                    plan, plan.remote_colkey, plan.remote_slot, ap, r,
                    bool(part[r]),
                ))
                changed |= old ^ new
                for k in old - new:
                    s = prov.get(k)
                    if s is not None:
                        s.discard(r)
                        if not s:
                            del prov[k]
                for k in new - old:
                    prov.setdefault(k, set()).add(r)
                if new:
                    rowp[r] = tuple(sorted(new))
                else:
                    rowp.pop(r, None)
                # reader side: the row's own local keys
                oldr = set(rowr.get(r, ()))
                valid = bool(np.asarray(ap.rp["valid"])[r])
                newr = set(_keys_of_row(
                    plan, plan.local_colkey, plan.local_slot, ap, r, valid
                ))
                for k in oldr - newr:
                    s = read.get(k)
                    if s is not None:
                        s.discard(r)
                        if not s:
                            del read[k]
                for k in newr - oldr:
                    read.setdefault(k, set()).add(r)
                if newr:
                    rowr[r] = tuple(sorted(newr))
                else:
                    rowr.pop(r, None)
            for k in changed:
                out |= read.get(k, set())
        out -= dirty
        if out:
            ap.bump_row_gen(out)
        return out

    # ---- tables ------------------------------------------------------------

    def delta_tables(self) -> List[Dict[str, np.ndarray]]:
        """The per-plan (uk, uc) runtime tables for 'tables'-mode
        dispatches, padded to power-of-two widths so the delta executable
        survives group-count drift."""
        out = []
        for prov in self.providers:
            n = len(prov)
            width = _pow2_bucket(n, TABLE_MIN)
            uk = np.full(width, KEY_INVALID, np.int32)
            uc = np.zeros(width, np.int32)
            if n:
                keys = np.fromiter(prov.keys(), np.int64, n)
                counts = np.fromiter(
                    (len(prov[int(k)]) for k in keys), np.int64, n
                )
                order = np.argsort(keys)
                uk[:n] = keys[order]
                uc[:n] = counts[order]
            out.append({"uk": uk, "uc": uc})
        return out

    def shapes(self) -> List[dict]:
        """Observability summary for /debug/routez (bounded, cheap)."""
        out = []
        for i, plan in enumerate(self.plans):
            prov = self.providers[i]
            out.append({
                "agg": plan.agg,
                "kind": plan.remote_kind,
                "scope": plan.remote_scope,
                "slot_key": plan.local_slot,
                "groups": len(prov),
                "provider_rows": sum(len(s) for s in prov.values()),
                "reader_rows": sum(
                    len(s) for s in self.readers[i].values()
                ),
            })
        return out

    # ---- snapshot persistence ---------------------------------------------

    def persist(self) -> dict:
        """Pickle-friendly form for the snapshot sweep basis."""
        return {
            "sig": list(self.sig),
            "providers": [
                {int(k): sorted(v) for k, v in prov.items()}
                for prov in self.providers
            ],
            "readers": [
                {int(k): sorted(v) for k, v in read.items()}
                for read in self.readers
            ],
            "row_pkeys": [
                {int(r): list(ks) for r, ks in rp.items()}
                for rp in self.row_pkeys
            ],
            "row_rkeys": [
                {int(r): list(ks) for r, ks in rr.items()}
                for rr in self.row_rkeys
            ],
        }

    @classmethod
    def restore(cls, plans: Tuple[JoinPlan, ...], data: dict,
                rebuild_gen: int) -> Optional["JoinState"]:
        """Rebuild a persisted index; None on plan drift (the caller then
        drops the whole sweep basis and rebases via a full sweep)."""
        st = cls(plans, rebuild_gen)
        if list(st.sig) != list(data.get("sig", ())):
            return None
        try:
            st.providers = [
                {int(k): set(v) for k, v in prov.items()}
                for prov in data["providers"]
            ]
            st.readers = [
                {int(k): set(v) for k, v in read.items()}
                for read in data["readers"]
            ]
            st.row_pkeys = [
                {int(r): tuple(ks) for r, ks in rp.items()}
                for rp in data["row_pkeys"]
            ]
            st.row_rkeys = [
                {int(r): tuple(ks) for r, ks in rr.items()}
                for rr in data["row_rkeys"]
            ]
        except (KeyError, TypeError, ValueError):
            return None
        if (
            len(st.providers) != len(st.plans)
            or len(st.readers) != len(st.plans)
        ):
            return None
        st.built = True
        return st


# ---------------------------------------------------------------------------
# Divergence assertion (satellite: interned-key parity oracle)
# ---------------------------------------------------------------------------


class JoinDivergence(AssertionError):
    """An exact join plan flagged a cell the interpreter oracle renders
    empty — the packed aggregate and the oracle disagree."""


def assert_enabled() -> bool:
    """GK_JOIN_ASSERT=1 arms the divergence assertion (parity tools and
    tests); GK_BUG_COMPAT=1 disarms it even then — compat mode reproduces
    reference quirks the strict tables deliberately do not."""
    if os.environ.get("GK_JOIN_ASSERT", "0") != "1":
        return False
    from ..engine.compat import bug_compat_enabled

    return not bug_compat_enabled()


def gv_twin_corner(js: "JoinState", plans, ap, row: int) -> bool:
    """True when a flagged-but-renders-empty cell is explained by the
    DOCUMENTED over-approximation corner (docs/referential.md "Known
    limits"): a dup/count plan's key group for this row contains two
    provider ROWS sharing one object identity (namespace, name) — two
    groupVersions of one object, which the reference's ``identical``
    helper and the count comprehension's [ns, name] head see as one.
    Such cells are legitimate filter work, not a divergence."""
    for plan in plans:
        if plan.agg not in ("dup", "count"):
            continue
        try:
            i = js.plans.index(plan)
        except ValueError:
            continue
        for k in js.row_rkeys[i].get(int(row), ()):
            rows = js.providers[i].get(k, ())
            idents = set()
            for r in rows:
                rv = ap.reviews[r] if r < len(ap.reviews) else None
                if rv is None:
                    continue
                idents.add((rv.get("namespace", ""), rv.get("name", "")))
            if len(idents) < len(rows):
                return True
    return False


def note_false_positive(kind: str, name: str, row: int):
    """Record (and under GK_JOIN_ASSERT raise on) an exact-join-plan cell
    whose interpreter render produced nothing."""
    from ..metrics.catalog import record_join_divergence

    record_join_divergence(kind)
    if assert_enabled():
        raise JoinDivergence(
            f"join plan flagged ({kind}/{name}, row {row}) but the "
            "interpreter oracle renders no violation — interned-key "
            "normalization or aggregate divergence"
        )


# ---------------------------------------------------------------------------
# Clause classification (called from ops/vectorizer.py)
# ---------------------------------------------------------------------------


def _is_wild(op) -> bool:
    from ..rego.ast import Var

    return isinstance(op, Var) and op.is_wildcard


def _scalar_str(op) -> Optional[str]:
    from ..rego.ast import Scalar

    if isinstance(op, Scalar) and isinstance(op.value, str):
        return op.value
    return None


def _inventory_iter(rhs) -> Optional[Tuple[str, str, Dict[str, Any]]]:
    """Recognize ``data.inventory.namespace[ns][gv][Kind][name]`` /
    ``data.inventory.cluster[gv][Kind][name]`` -> (scope, kind,
    {"ns": var|None, "name": var|None}).  Non-kind operands must be
    wildcards or plain vars (bound only inside a comprehension head)."""
    from ..rego.ast import Ref, Var

    if not (isinstance(rhs, Ref) and isinstance(rhs.head, Var)
            and rhs.head.name == "data"):
        return None
    ops = rhs.operands
    if not ops or _scalar_str(ops[0]) != "inventory":
        return None
    ops = ops[1:]
    scope = _scalar_str(ops[0]) if ops else None
    if scope == "namespace" and len(ops) == 5:
        ns_op, gv_op, kind_op, name_op = ops[1], ops[2], ops[3], ops[4]
    elif scope == "cluster" and len(ops) == 4:
        ns_op, gv_op, kind_op, name_op = None, ops[1], ops[2], ops[3]
    else:
        return None
    kind = _scalar_str(kind_op)
    if kind is None:
        return None

    def var_or_wild(op):
        return op is None or isinstance(op, Var)

    if not (var_or_wild(ns_op) and var_or_wild(gv_op)
            and var_or_wild(name_op)):
        return None
    return scope, kind, {"ns": ns_op, "gv": gv_op, "name": name_op}


def _remote_rel_path(rhs, inv_var: str) -> Optional[Tuple[str, ...]]:
    """``other.spec.rules[_].host`` -> ('spec', 'rules', '[]', 'host')."""
    from ..rego.ast import Ref, Var

    if not (isinstance(rhs, Ref) and isinstance(rhs.head, Var)
            and rhs.head.name == inv_var):
        return None
    segs: List[str] = []
    for op in rhs.operands:
        s = _scalar_str(op)
        if s is not None:
            segs.append(s)
        elif _is_wild(op):
            segs.append("[]")
        else:
            return None
    return tuple(segs)


def _remote_colspec(rel: Tuple[str, ...]):
    """Remote rel path (object-relative) -> joinkey ColumnSpec over the
    packed review rows (which nest the raw object under 'object')."""
    from .columns import ColumnSpec

    segs = ("object",) + rel
    if "[]" in segs:
        last = len(segs) - 1 - segs[::-1].index("[]")
        return ColumnSpec(
            "joinkey", (tuple(segs[: last + 1]),), tuple(segs[last + 1:])
        ), True
    return ColumnSpec("joinkey", (), segs), False


def _vars_in(node) -> set:
    """Non-wildcard variable names referenced anywhere under a term."""
    from ..rego.ast import (
        ArrayCompr, ArrayTerm, BinOp, Call, ObjectCompr, ObjectTerm, Ref,
        SetCompr, SetTerm, UnaryMinus, Var,
    )

    out: set = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, Var):
            if not n.is_wildcard:
                out.add(n.name)
        elif isinstance(n, Ref):
            stack.append(n.head)
            stack.extend(n.operands)
        elif isinstance(n, Call):
            stack.extend(n.args)
        elif isinstance(n, (ArrayTerm, SetTerm)):
            stack.extend(n.items)
        elif isinstance(n, ObjectTerm):
            for k, v in n.pairs:
                stack.append(k)
                stack.append(v)
        elif isinstance(n, (ArrayCompr, SetCompr)):
            stack.append(n.head)
            for e in n.body:
                stack.extend(e.terms)
        elif isinstance(n, ObjectCompr):
            stack.append(n.key)
            stack.append(n.value)
            for e in n.body:
                stack.extend(e.terms)
        elif isinstance(n, BinOp):
            stack.append(n.lhs)
            stack.append(n.rhs)
        elif isinstance(n, UnaryMinus):
            stack.append(n.operand)
    return out


class _NoMatch(Exception):
    pass


class _ClauseScan:
    """Order-insensitive partition of a violation clause body into the
    roles the family matchers consume.  The rego safety pass may reorder
    statements, so nothing here depends on source order."""

    def __init__(self, vec, rule):
        self.vec = vec
        self.rule = rule
        self.assigns: List = []        # (lhs_name, rhs, stmt)
        self.conds: List = []          # plain term statements
        self.nots: List = []           # 'not' statements
        for stmt in rule.body:
            if stmt.withs:
                raise _NoMatch()  # document patching: interpreter-only
            if stmt.kind == "some":
                continue
            if stmt.kind in ("assign", "unify"):
                from ..rego.ast import Var

                lhs = stmt.terms[0]
                if isinstance(lhs, Var):
                    self.assigns.append((lhs.name, stmt.terms[1], stmt))
                    continue
                raise _NoMatch()
            if stmt.kind == "not":
                self.nots.append(stmt)
                continue
            self.conds.append(stmt)


def _local_key_operand(vec, rhs, state):
    """Resolve a local key source (iteration -> slot, or a review-rooted
    scalar path) and register its joinkey column.  Returns
    (colkey, slot?)."""
    from .columns import ColumnSpec
    from .vectorizer import SPath, _Unsupported

    try:
        it = vec._try_iteration(rhs, {}, state)
    except _Unsupported:
        it = None
    if it is not None:
        spec = ColumnSpec("joinkey", it.root[1], tuple(it.segs))
        vec.columns[spec.key] = spec
        return spec.key, True
    try:
        sym = vec._resolve(rhs, {}, state)
    except _Unsupported:
        raise _NoMatch()
    if isinstance(sym, SPath) and sym.root == "review":
        spec = ColumnSpec("joinkey", (), tuple(sym.segs))
        vec.columns[spec.key] = spec
        return spec.key, False
    raise _NoMatch()


def _check_benign_guards(scan, consumed: set, remote_vars: set):
    """Assignments the matcher did not consume must be benign calls
    (sprintf & friends) referencing no remote entity — a message that
    embeds the OTHER row's fields depends on group content the delta
    invalidation cannot see, so such clauses stay on the interpreter
    tier.  The violation head is checked the same way."""
    from ..rego.ast import Call

    from .vectorizer import _BENIGN_CALLS

    for name, rhs, _stmt in scan.assigns:
        if name in consumed:
            continue
        if not (isinstance(rhs, Call)
                and ".".join(rhs.path) in _BENIGN_CALLS):
            raise _NoMatch()
        if _vars_in(rhs) & remote_vars:
            raise _NoMatch()
    if scan.rule.key is not None and _vars_in(scan.rule.key) & remote_vars:
        raise _NoMatch()


def _match_dup(vec, scan: _ClauseScan):
    """unique-key family: local (slot or scalar) key, an inventory
    iteration of the same kind, a remote key equal to the local key, and
    an object-identity self-exclusion helper under ``not``."""
    from ..rego.ast import BinOp, Call, Ref, Var

    state = {"slot": None}
    inv = None
    inv_var = None
    for name, rhs, _stmt in scan.assigns:
        got = _inventory_iter(rhs)
        if got is not None:
            if inv is not None:
                raise _NoMatch()
            # violation-clause inventory vars must be wildcards: a bound
            # scope var would correlate with the local row (unsupported)
            scope, kind, vs = got
            for v in (vs["ns"], vs["gv"], vs["name"]):
                if v is not None and not v.is_wildcard:
                    raise _NoMatch()
            inv, inv_var = (scope, kind), name
    if inv is None:
        raise _NoMatch()
    scope, kind = inv
    # remote key: either a var assigned from `other.<path>[_]...` or a
    # direct `other.<path> == key` comparison side
    remote_key_vars: Dict[str, Tuple[str, ...]] = {}
    for name, rhs, _stmt in scan.assigns:
        if name == inv_var:
            continue
        rel = _remote_rel_path(rhs, inv_var)
        if rel is not None:
            remote_key_vars[name] = rel

    # the equality condition joining local and remote keys decides which
    # local var is the key
    remote_rel = None
    local_var = None
    for stmt in scan.conds:
        t = stmt.terms[0]
        if not (isinstance(t, BinOp) and t.op == "=="):
            raise _NoMatch()
        for a, b in ((t.lhs, t.rhs), (t.rhs, t.lhs)):
            if not isinstance(a, Var) or a.name in remote_key_vars \
                    or a.name == inv_var:
                continue
            rel = (
                remote_key_vars.get(b.name)
                if isinstance(b, Var) else _remote_rel_path(b, inv_var)
            )
            if rel is not None:
                if remote_rel is not None:
                    raise _NoMatch()  # one join equality per clause
                remote_rel, local_var = rel, a.name
                break
        else:
            raise _NoMatch()
    if remote_rel is None or local_var is None:
        raise _NoMatch()
    local_key = None
    for name, rhs, _stmt in scan.assigns:
        if name == local_var:
            local_key = _local_key_operand(vec, rhs, state)
    if local_key is None:
        raise _NoMatch()

    # the self-exclusion: not identical(other, input.review)
    if len(scan.nots) != 1:
        raise _NoMatch()
    inner = scan.nots[0].terms[0]
    t = inner.terms[0] if getattr(inner, "kind", None) == "term" else None
    if not (isinstance(t, Call) and len(t.path) == 1 and len(t.args) == 2):
        raise _NoMatch()
    a0, a1 = t.args
    if not (isinstance(a0, Var) and a0.name == inv_var):
        raise _NoMatch()
    if not (isinstance(a1, Ref) and isinstance(a1.head, Var)
            and a1.head.name == "input"
            and [_scalar_str(op) for op in a1.operands] == ["review"]):
        raise _NoMatch()
    _check_identity_helper(vec, t.path[0], scope)

    remote_vars = {inv_var} | set(remote_key_vars)
    _check_benign_guards(scan, {local_var, inv_var} | set(remote_key_vars),
                         remote_vars)

    from .vexpr import Clause, JoinCmp, Lit

    rspec, rslot = _remote_colspec(remote_rel)
    if (rspec.key, rslot) != (local_key[0], local_key[1]):
        # self-exclusion (counts - own contribution) is only exact when
        # the local key IS the row's provider key — different local and
        # remote paths stay on the interpreter tier
        raise _NoMatch()
    vec.columns[rspec.key] = rspec
    plan = JoinPlan(
        agg="dup", local_colkey=local_key[0], local_slot=local_key[1],
        remote_scope=scope, remote_kind=kind,
        remote_colkey=rspec.key, remote_slot=rslot,
    )
    pid = _register_plan(vec, plan)
    # "another object provides my key": distinct provider rows at the
    # key, minus this row's own contribution, >= 1
    node = JoinCmp(pid, ">=", Lit(1), slot=local_key[1],
                   exclude_self=True)
    return Clause(conds=(node,), slot_iter=state["slot"])


def _check_identity_helper(vec, name: str, scope: str):
    """The self-exclusion helper must compare exactly the fields that
    identify an object in the plan's scope: metadata.name (+ namespace
    when namespace-scoped).  Anything else narrows or widens identity in
    ways the distinct-row aggregate cannot express."""
    from ..rego.ast import BinOp, Ref, Var

    rules = vec.cm.rules.get(name) or []
    if len(rules) != 1:
        raise _NoMatch()
    r = rules[0]
    if not r.is_function or len(r.args or ()) != 2 or r.els is not None:
        raise _NoMatch()
    if r.value is not None:
        from ..rego.ast import Scalar

        if not (isinstance(r.value, Scalar) and r.value.value is True):
            raise _NoMatch()
    o_var, rv_var = r.args
    if not (isinstance(o_var, Var) and isinstance(rv_var, Var)):
        raise _NoMatch()
    fields = set()
    for stmt in r.body:
        if stmt.kind != "term" or not isinstance(stmt.terms[0], BinOp):
            raise _NoMatch()
        b = stmt.terms[0]
        if b.op != "==":
            raise _NoMatch()

        def field_of(t, head, prefix):
            if not (isinstance(t, Ref) and isinstance(t.head, Var)
                    and t.head.name == head):
                return None
            segs = [_scalar_str(op) for op in t.operands]
            if None in segs or segs[:-1] != prefix:
                return None
            return segs[-1]

        for a, b2 in ((b.lhs, b.rhs), (b.rhs, b.lhs)):
            f1 = field_of(a, o_var.name, ["metadata"])
            f2 = field_of(b2, rv_var.name, ["object", "metadata"])
            if f1 is not None and f2 is not None and f1 == f2:
                fields.add(f1)
                break
        else:
            raise _NoMatch()
    want = {"name", "namespace"} if scope == "namespace" else {"name"}
    if fields != want:
        raise _NoMatch()


def _match_exists(vec, scan: _ClauseScan):
    """required-reference family: a local reference value and a ``not
    exists(ref)`` helper iterating the inventory for a row whose remote
    key equals it."""
    from ..rego.ast import BinOp, Call, Ref, Var

    if len(scan.nots) != 1 or scan.conds:
        raise _NoMatch()
    inner = scan.nots[0].terms[0]
    t = inner.terms[0] if getattr(inner, "kind", None) == "term" else None
    if not (isinstance(t, Call) and len(t.path) == 1 and len(t.args) == 1):
        raise _NoMatch()
    arg = t.args[0]
    if not isinstance(arg, Var):
        raise _NoMatch()
    local_var = arg.name
    state = {"slot": None}
    local_key = None
    for name, rhs, _stmt in scan.assigns:
        if name == local_var:
            local_key = _local_key_operand(vec, rhs, state)
    if local_key is None:
        raise _NoMatch()

    # the helper: one clause, one inventory iteration + one equality
    rules = vec.cm.rules.get(t.path[0]) or []
    if len(rules) != 1:
        raise _NoMatch()
    r = rules[0]
    if not r.is_function or len(r.args or ()) != 1 or r.els is not None:
        raise _NoMatch()
    p = r.args[0]
    if not isinstance(p, Var):
        raise _NoMatch()
    inv = None
    inv_var = None
    eqs = []
    for stmt in r.body:
        if stmt.withs:
            raise _NoMatch()
        if stmt.kind in ("assign", "unify") and isinstance(
            stmt.terms[0], Var
        ):
            got = _inventory_iter(stmt.terms[1])
            if got is not None and inv is None:
                scope, kind, vs = got
                for v in (vs["ns"], vs["gv"], vs["name"]):
                    if v is not None and not v.is_wildcard:
                        raise _NoMatch()
                inv, inv_var = (scope, kind), stmt.terms[0].name
                continue
            raise _NoMatch()
        if stmt.kind == "term" and isinstance(stmt.terms[0], BinOp):
            eqs.append(stmt.terms[0])
            continue
        raise _NoMatch()
    if inv is None or len(eqs) != 1:
        raise _NoMatch()
    scope, kind = inv
    b = eqs[0]
    if b.op != "==":
        raise _NoMatch()
    remote_rel = None
    for a, c in ((b.lhs, b.rhs), (b.rhs, b.lhs)):
        rel = _remote_rel_path(a, inv_var)
        if rel is not None and isinstance(c, Var) and c.name == p.name:
            remote_rel = rel
    if remote_rel is None:
        raise _NoMatch()

    _check_benign_guards(scan, {local_var}, set())

    from .vexpr import Clause, JoinCmp, Lit

    rspec, rslot = _remote_colspec(remote_rel)
    vec.columns[rspec.key] = rspec
    plan = JoinPlan(
        agg="exists", local_colkey=local_key[0], local_slot=local_key[1],
        remote_scope=scope, remote_kind=kind,
        remote_colkey=rspec.key, remote_slot=rslot,
    )
    pid = _register_plan(vec, plan)
    node = JoinCmp(pid, "==", Lit(0), slot=local_key[1])
    return Clause(conds=(node,), slot_iter=state["slot"])


def _match_count(vec, scan: _ClauseScan):
    """count-quota family: ``n := count({ident | p := data.inventory...;
    p.<path> == key})`` compared against a parameter (or literal)."""
    from ..rego.ast import ArrayTerm, BinOp, Call, SetCompr, Var

    from .vectorizer import SConst, SPath, _Unsupported

    if scan.nots:
        raise _NoMatch()
    count_var = None
    compr = None
    for name, rhs, _stmt in scan.assigns:
        if (isinstance(rhs, Call) and rhs.path == ("count",)
                and len(rhs.args) == 1
                and isinstance(rhs.args[0], SetCompr)):
            if count_var is not None:
                raise _NoMatch()
            count_var, compr = name, rhs.args[0]
    if compr is None:
        raise _NoMatch()

    # the comprehension body: inventory iteration (scope vars may bind)
    # + one equality between a remote rel path and an outer-scope key
    inv = None
    inv_var = None
    inv_vars: Dict[str, Any] = {}
    eqs = []
    for stmt in compr.body:
        if stmt.withs:
            raise _NoMatch()
        if stmt.kind in ("assign", "unify") and isinstance(
            stmt.terms[0], Var
        ):
            got = _inventory_iter(stmt.terms[1])
            if got is not None and inv is None:
                scope, kind, vs = got
                inv, inv_var = (scope, kind), stmt.terms[0].name
                inv_vars = vs
                continue
            raise _NoMatch()
        if stmt.kind == "term" and isinstance(stmt.terms[0], BinOp):
            eqs.append(stmt.terms[0])
            continue
        raise _NoMatch()
    if inv is None or len(eqs) != 1:
        raise _NoMatch()
    scope, kind = inv
    b = eqs[0]
    if b.op != "==":
        raise _NoMatch()
    remote_rel = None
    key_var = None
    for a, c in ((b.lhs, b.rhs), (b.rhs, b.lhs)):
        rel = _remote_rel_path(a, inv_var)
        if rel is not None and isinstance(c, Var):
            remote_rel, key_var = rel, c.name
    if remote_rel is None:
        raise _NoMatch()

    # the head must enumerate object IDENTITY so count() counts distinct
    # inventory rows: [ns, name] when namespaced, the name var clusterwide
    def head_ok():
        ns_v = inv_vars.get("ns")
        name_v = inv_vars.get("name")
        name_name = name_v.name if isinstance(name_v, Var) and not \
            name_v.is_wildcard else None
        if name_name is None:
            return False
        if scope == "cluster":
            h = compr.head
            return isinstance(h, Var) and h.name == name_name
        ns_name = ns_v.name if isinstance(ns_v, Var) and not \
            ns_v.is_wildcard else None
        h = compr.head
        if ns_name is None or not isinstance(h, ArrayTerm):
            return False
        names = [
            x.name for x in h.items
            if isinstance(x, Var) and not x.is_wildcard
        ]
        return len(h.items) == 2 and sorted(names) == sorted(
            [ns_name, name_name]
        )

    if not head_ok():
        raise _NoMatch()

    # local key: the outer assignment the comprehension's key var names
    state = {"slot": None}
    local_key = None
    for name, rhs, _stmt in scan.assigns:
        if name == key_var:
            local_key = _local_key_operand(vec, rhs, state)
    if local_key is None or local_key[1]:
        raise _NoMatch()  # quota keys are scalar (one group per row)

    # the threshold comparison: n <op> parameter/literal
    cmp_node = None
    for stmt in scan.conds:
        t = stmt.terms[0]
        if not isinstance(t, BinOp):
            raise _NoMatch()
        from .vectorizer import _CMP_OPS, _flip

        if t.op not in _CMP_OPS:
            raise _NoMatch()
        for a, c, op in ((t.lhs, t.rhs, t.op), (t.rhs, t.lhs, _flip(t.op))):
            if isinstance(a, Var) and a.name == count_var:
                try:
                    sym = vec._resolve(c, {}, state)
                except _Unsupported:
                    raise _NoMatch()
                from .vexpr import Lit, ParamRef

                if isinstance(sym, SPath) and sym.root == "params":
                    vec.param_scalars.add(sym.segs)
                    rhs_op = ParamRef(sym.segs)
                elif isinstance(sym, SConst) and isinstance(
                    sym.value, (int, float)
                ) and not isinstance(sym.value, bool):
                    rhs_op = Lit(sym.value)
                else:
                    raise _NoMatch()
                if cmp_node is not None:
                    raise _NoMatch()
                cmp_node = (op, rhs_op)
                break
        else:
            raise _NoMatch()
    if cmp_node is None:
        raise _NoMatch()

    _check_benign_guards(scan, {key_var, count_var}, set())

    from .vexpr import Clause, JoinCmp

    rspec, rslot = _remote_colspec(remote_rel)
    vec.columns[rspec.key] = rspec
    plan = JoinPlan(
        agg="count", local_colkey=local_key[0], local_slot=False,
        remote_scope=scope, remote_kind=kind,
        remote_colkey=rspec.key, remote_slot=rslot,
    )
    pid = _register_plan(vec, plan)
    node = JoinCmp(pid, cmp_node[0], cmp_node[1], slot=False)
    return Clause(conds=(node,), slot_iter=None)


def _register_plan(vec, plan: JoinPlan) -> int:
    plans = vec.join_plans
    for i, p in enumerate(plans):
        if p == plan:
            return i
    plans.append(plan)
    return len(plans) - 1


def classify_join_clause(vec, rule):
    """Try every referential family matcher against a violation clause.
    Returns a vexpr Clause (with the JoinPlan registered on the
    vectorizer) or None when no family matches — the caller then falls
    back to the generic (over-approximate) compilation."""
    try:
        scan = _ClauseScan(vec, rule)
    except _NoMatch:
        return None
    for matcher in (_match_count, _match_dup, _match_exists):
        try:
            return matcher(vec, scan)
        except _NoMatch:
            continue
    return None
