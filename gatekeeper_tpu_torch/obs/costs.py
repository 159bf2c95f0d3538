"""Per-template / per-constraint cost attribution ledger.

Earlier work instrumented the hot paths (stage histograms, spans) and added
`last_render_stats`, but neither *attributes* device or render time to the
ConstraintTemplate that caused it — the operator of a 500-template cluster
cannot answer "which template is eating the TPU?".  This ledger closes
that gap:

- The driver feeds it at the same pass boundaries where the stage metrics
  record (one call per dispatch / render pass, never per cell): dispatch
  device-seconds apportioned across templates by evaluated cells, render
  seconds apportioned across flagged constraints by rendered cells, plus
  per-constraint tier mix, review-memo hits, and violation counts.
- State lives in DECAYING WINDOWS: a ring of coarse time buckets whose
  aggregate is "the last ``window_s`` seconds"; an expiring bucket folds
  into the cumulative totals, so totals-since-start stay exact without a
  second store write on the hot path.  Monotonic clock only.
- Cardinality is BOUNDED twice: internally at ``max_tracked``
  (template, constraint) keys (overflow folds into the ``other`` row —
  adversarial template churn cannot grow the ledger), and at export at
  ``top_k`` template label values + one ``other`` rollup (the
  label-cardinality contract tools/check_observability.py lints).

Hot-path cost model (the bench.py ``slo`` config measures the total at
<3% of the violating-unique admission p50):

- ``record_dispatch`` is O(1): the per-kind expansion is deferred.  A
  dispatch's per-template device-ms share is ``n_k / N_total`` of the
  dispatch time — independent of the row count — so dispatches against
  the same (epoch-cached) kind-count dict accumulate as one
  ``(device_s_sum, rows_sum)`` pair and expand to per-template rows only
  when the bucket rolls or a query arrives (a scrape, /debug/costs).
- ``record_render`` is O(flagged constraints) with a single store write
  per entry.

A telemetry defect must never fail the evaluation being measured — every
module-level recorder is guarded, mirroring metrics.catalog.record_stage.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from ..metrics.catalog import record_dropped as _record_dropped

# the internal overflow key; exported as the "other" rollup
OTHER = "other"

_FIELDS = (
    "device_ms", "render_ms", "eval_cells", "render_cells",
    "static", "slots", "interp", "memo_hits", "violations",
)


class _Row:
    """One (template, constraint) accumulator."""

    __slots__ = _FIELDS

    def __init__(self):
        self.device_ms = 0.0
        self.render_ms = 0.0
        self.eval_cells = 0.0
        self.render_cells = 0.0
        self.static = 0.0
        self.slots = 0.0
        self.interp = 0.0
        self.memo_hits = 0.0
        self.violations = 0.0

    def merge(self, other: "_Row"):
        for f in _FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def to_dict(self) -> dict:
        return {
            "device_ms": round(self.device_ms, 4),
            "render_ms": round(self.render_ms, 4),
            "cells": int(self.eval_cells),
            "render_cells": int(self.render_cells),
            "tier_mix": {
                "static": int(self.static),
                "slots": int(self.slots),
                "interp": int(self.interp),
            },
            "memo_hits": int(self.memo_hits),
            "violations": int(self.violations),
        }


class _Bucket:
    """One time bucket: expanded rows + deferred dispatch accumulators
    keyed by the identity of the caller's kind-count dict (the driver
    caches one per constraint-side epoch; the entry holds a strong ref,
    so the id stays valid for the entry's lifetime)."""

    __slots__ = ("idx", "rows", "pending")

    def __init__(self, idx: int):
        self.idx = idx
        self.rows: Dict[Tuple[str, str], _Row] = {}
        self.pending: Dict[int, list] = {}  # id -> [kinds, dev_s, rows]


class CostLedger:
    """Decaying-window per-template/per-constraint cost accounting."""

    def __init__(
        self,
        top_k: int = 20,
        window_s: float = 300.0,
        bucket_s: float = 30.0,
        # a 500-template cluster tracks ~2 keys per template (the
        # template dispatch row + one per constraint); rows are ~9
        # floats, so even the cap costs <1MB
        max_tracked: int = 4096,
        clock=time.monotonic,
    ):
        self._lock = threading.Lock()
        self._clock = clock
        self.top_k = max(1, int(top_k))
        self.window_s = float(window_s)
        self.bucket_s = max(1.0, float(bucket_s))
        self.max_tracked = max(self.top_k, int(max_tracked))
        self.enabled = True
        self._buckets: deque = deque()  # of _Bucket, oldest first
        # cumulative totals: EXPIRED buckets only — queries fold the live
        # buckets in, so the hot path writes one store
        self._totals: Dict[Tuple[str, str], _Row] = {}
        # every key ever tracked (the cardinality population)
        self._known: set = set()
        self._dropped = 0  # keys folded into OTHER by the cardinality cap
        # label values exported on the last collect(): gauge rows for
        # templates that left the top-K must be retracted to 0, or they
        # report stale costs forever (the report_sync pattern)
        self._exported: set = set()

    # ---- recording ---------------------------------------------------------

    def _resolve(self, key: Tuple[str, str]) -> Tuple[str, str]:
        """Cardinality cap: once ``max_tracked`` distinct keys exist,
        new ones fold into OTHER everywhere.  Caller holds the lock."""
        if key in self._known:
            return key
        if len(self._known) < self.max_tracked:
            self._known.add(key)
            return key
        self._dropped += 1
        return (OTHER, "")

    @staticmethod
    def _row(store: Dict[Tuple[str, str], _Row],
             key: Tuple[str, str]) -> _Row:
        row = store.get(key)
        if row is None:
            row = store[key] = _Row()
        return row

    def _expand_pending(self, bucket: _Bucket):
        """Fold a bucket's deferred dispatch accumulators into its rows.
        Caller holds the lock."""
        for kinds, device_s, rows_sum in bucket.pending.values():
            total_n = sum(kinds.values())
            if total_n <= 0:
                continue
            ms_per_constraint = device_s * 1e3 / total_n
            for kind, n in kinds.items():
                row = self._row(bucket.rows, self._resolve((kind, "")))
                row.device_ms += ms_per_constraint * n
                row.eval_cells += float(n) * rows_sum
        bucket.pending.clear()

    def _bucket(self, now: float) -> _Bucket:
        """Current bucket; rolls, expires (expired buckets fold into the
        cumulative totals).  Caller holds the lock."""
        idx = int(now // self.bucket_s)
        if not self._buckets or self._buckets[-1].idx != idx:
            self._buckets.append(_Bucket(idx))
        horizon = idx - int(self.window_s // self.bucket_s) - 1
        while self._buckets and self._buckets[0].idx < horizon:
            old = self._buckets.popleft()
            self._expand_pending(old)
            for key, row in old.rows.items():
                self._row(self._totals, key).merge(row)
        return self._buckets[-1]

    def record_dispatch(self, kind_constraints: Dict[str, int],
                        device_s: float, rows: int, path: str = "review"):
        """One device (or numpy-tier) dispatch: ``device_s`` apportioned
        across templates by evaluated cells (= constraints-of-kind x
        rows; a batched dispatch evaluates every cell, flagged or not).
        O(1): per-kind expansion is deferred to the bucket roll/query."""
        if not self.enabled or not kind_constraints or rows <= 0:
            return
        with self._lock:
            pending = self._bucket(self._clock()).pending
            ent = pending.get(id(kind_constraints))
            if ent is None:
                pending[id(kind_constraints)] = [
                    kind_constraints, device_s, float(rows)
                ]
            else:
                ent[1] += device_s
                ent[2] += rows

    def record_render(self, entries: Iterable[Tuple],
                      plan_s: float = 0.0, interp_s: float = 0.0):
        """One render pass.  ``entries`` are per-constraint tuples
        ``(kind, name, cells, tier, violations, memo_hits)``; the pass's
        render seconds are apportioned by rendered cells."""
        if not self.enabled:
            return
        entries = list(entries)
        if not entries:
            return
        total_cells = float(sum(e[2] for e in entries)) or 1.0
        ms_per_cell = (plan_s + interp_s) * 1e3 / total_cells
        with self._lock:
            rows = self._bucket(self._clock()).rows
            for kind, name, cells, tier, violations, memo_hits in entries:
                row = self._row(rows, self._resolve((kind, name or "")))
                row.render_ms += ms_per_cell * cells
                row.render_cells += cells
                if tier == "static":
                    row.static += cells
                elif tier == "slots":
                    row.slots += cells
                else:
                    row.interp += cells
                row.memo_hits += memo_hits
                row.violations += violations

    # ---- querying ----------------------------------------------------------

    def _live_buckets(self) -> List[_Bucket]:
        """Roll/expire, expand every live pending, and return the live
        window's buckets.  Caller holds the lock."""
        self._bucket(self._clock())  # roll + expire
        for b in self._buckets:
            if b.pending:
                self._expand_pending(b)
        horizon = self._buckets[-1].idx - int(
            self.window_s // self.bucket_s
        )
        return [b for b in self._buckets if b.idx >= horizon]

    @staticmethod
    def _fold(stores: Iterable[Dict[Tuple[str, str], _Row]],
              by_template: bool) -> Dict:
        out: Dict = {}
        for store in stores:
            for key, row in store.items():
                k = key[0] if by_template else key
                agg = out.get(k)
                if agg is None:
                    agg = out[k] = _Row()
                agg.merge(row)
        return out

    def snapshot(self, top: Optional[int] = None) -> dict:
        """The /debug/costs payload: top-K templates by window cost
        (device+render ms) with an ``other`` rollup, per-template tier
        mix and per-constraint breakdown, plus cumulative totals."""
        top = self.top_k if top is None else max(1, int(top))
        with self._lock:
            live = self._live_buckets()
            window = self._fold((b.rows for b in live), by_template=True)
            ranked = sorted(
                (k for k in window if k != OTHER),
                key=lambda k: window[k].device_ms + window[k].render_ms,
                reverse=True,
            )
            head, tail = ranked[:top], ranked[top:]
            other = _Row()
            if OTHER in window:
                other.merge(window[OTHER])
            for k in tail:
                other.merge(window[k])
            # per-constraint breakdown inside the window for the head
            head_set = set(head)
            cons = {}
            for b in live:
                for key, row in b.rows.items():
                    if key[0] in head_set and key[1]:
                        agg = cons.get(key)
                        if agg is None:
                            agg = cons[key] = _Row()
                        agg.merge(row)
            by_constraint: Dict[str, List[dict]] = {}
            for (kind, name), row in cons.items():
                by_constraint.setdefault(kind, []).append(
                    {"constraint": name, **row.to_dict()}
                )
            templates = []
            for k in head:
                entry = {"template": k, **window[k].to_dict()}
                if k in by_constraint:
                    entry["constraints"] = sorted(
                        by_constraint[k],
                        key=lambda c: c["render_ms"], reverse=True,
                    )
                templates.append(entry)
            total = _Row()
            for row in self._fold(
                [self._totals] + [b.rows for b in self._buckets],
                by_template=True,
            ).values():
                total.merge(row)
            return {
                "window_s": self.window_s,
                "top": top,
                "templates": templates,
                "other": other.to_dict(),
                "tracked_templates": len(window),
                "dropped_keys": self._dropped,
                "totals": total.to_dict(),
            }

    def totals_by_template(self) -> Dict[str, dict]:
        """Cumulative per-template rows (tests / tooling)."""
        with self._lock:
            for b in self._buckets:
                if b.pending:
                    self._expand_pending(b)
            folded = self._fold(
                [self._totals] + [b.rows for b in self._buckets],
                by_template=True,
            )
            return {k: r.to_dict() for k, r in folded.items()}

    # ---- metrics export ----------------------------------------------------

    def collect(self, registry) -> None:
        """Record the window aggregates as ``gatekeeper_cost_*`` gauges
        (top-K + ``other``), retracting rows for templates that left the
        exported set.  Called as a MetricsExporter pre-scrape hook."""
        from ..metrics import catalog as cat

        cat.register_catalog(registry)  # idempotent: rows need their views
        snap = self.snapshot()
        rows = list(snap["templates"]) + [
            {"template": OTHER, **snap["other"]}
        ]
        exported = set()
        for entry in rows:
            t = entry["template"]
            exported.add(t)
            tags = {"template": t}
            registry.record(cat.COST_DEVICE_MS_M, entry["device_ms"], tags)
            registry.record(cat.COST_RENDER_MS_M, entry["render_ms"], tags)
            registry.record(cat.COST_CELLS_M, float(entry["cells"]), tags)
            registry.record(
                cat.COST_VIOLATIONS_M, float(entry["violations"]), tags
            )
            rc = float(entry["render_cells"])
            registry.record(
                cat.COST_MEMO_HIT_RATIO_M,
                (entry["memo_hits"] / (rc + entry["memo_hits"]))
                if (rc + entry["memo_hits"]) > 0 else 0.0,
                tags,
            )
            for plan, n in entry["tier_mix"].items():
                registry.record(
                    cat.COST_RENDER_CELLS_M, float(n),
                    {"template": t, "plan": plan},
                )
        with self._lock:
            stale, self._exported = self._exported - exported, exported
        for t in stale:
            tags = {"template": t}
            registry.record(cat.COST_DEVICE_MS_M, 0.0, tags)
            registry.record(cat.COST_RENDER_MS_M, 0.0, tags)
            registry.record(cat.COST_CELLS_M, 0.0, tags)
            registry.record(cat.COST_VIOLATIONS_M, 0.0, tags)
            registry.record(cat.COST_MEMO_HIT_RATIO_M, 0.0, tags)
            for plan in ("static", "slots", "interp"):
                registry.record(
                    cat.COST_RENDER_CELLS_M, 0.0,
                    {"template": t, "plan": plan},
                )

    def clear(self):
        # _exported survives on purpose: the registry still holds the
        # previously exported gauge rows, and the next collect() must
        # retract them rather than forget they exist
        with self._lock:
            self._buckets.clear()
            self._totals.clear()
            self._known.clear()
            self._dropped = 0


_LEDGER = CostLedger()
if os.environ.get("GK_COST_LEDGER", "1") == "0":  # kill switch
    _LEDGER.enabled = False


def get_ledger() -> CostLedger:
    return _LEDGER


def enabled() -> bool:
    """One-attribute check the driver uses to gate its (cheap) per-pass
    attribution prep — disabled means truly zero added work."""
    return _LEDGER.enabled


def configure(top_k: Optional[int] = None, window_s: Optional[float] = None,
              enabled: Optional[bool] = None):
    if top_k is not None:
        _LEDGER.top_k = max(1, int(top_k))
        _LEDGER.max_tracked = max(_LEDGER.top_k, _LEDGER.max_tracked)
    if window_s is not None:
        _LEDGER.window_s = float(window_s)
    if enabled is not None:
        _LEDGER.enabled = bool(enabled)


def record_dispatch(kind_constraints: Dict[str, int], device_s: float,
                    rows: int, path: str = "review"):
    try:
        _LEDGER.record_dispatch(kind_constraints, device_s, rows, path)
    except Exception:  # telemetry never blocks eval
        _record_dropped("costs.record_dispatch")


def record_render(entries: Iterable[Tuple], plan_s: float = 0.0,
                  interp_s: float = 0.0):
    try:
        _LEDGER.record_render(entries, plan_s, interp_s)
    except Exception:  # telemetry never blocks eval
        _record_dropped("costs.record_render")


def collect_hook(registry):
    """MetricsExporter pre-scrape hook (guarded: a ledger defect must
    never break the /metrics scrape)."""
    try:
        _LEDGER.collect(registry)
    except Exception:  # telemetry never blocks scrape
        _record_dropped("costs.collect_hook")
