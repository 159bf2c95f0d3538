"""Route-decision ledger: every `_route_eval`
pricing decision the driver makes, recorded — shape, offered load, the
priced tier table, the chosen tier and the overriding reason — so the
router stops being a black box.  ROADMAP item 3 (widen the compiled
tier) is gated on seeing exactly WHERE the compiled tier loses; this
ledger is that measurement.

Each TpuDriver owns one bounded ledger (`driver.route_ledger`).  A
decision entry is:

  {seq, t, cells, n_reviews, per_review_cells, lam, tier, reason, priced}

where ``priced`` is the affine service-model table the decision priced —
[{tier, floor_ms, per_review_ms, predicted_ms, mu_rps}] — and ``reason``
names what decided (or overrode) the choice:

  forced_device        GK_DEVICE_MIN_CELLS=0 pins the device tier
  uncalibrated_prior   no calibration yet: the static cell thresholds
  latency              calibrated min-predicted-latency choice
  load_aware           offered-λ feasibility filter picked the cheapest
                       SUSTAINABLE tier
  saturated            no tier sustains λ: max-throughput drain choice
  brownout_pin         obs/brownout.py level 3 pinned max-throughput
  breaker_open         the breaker diverted a device choice to a host tier
  compile_pending      async compile in flight diverted a device choice
  device_failed        the dispatch raised; this batch fell back host-side

Aggregations maintained alongside the ring:

- ``route_decisions_total{tier,reason}`` (metrics catalog);
- a bounded per-shape tier-win table keyed by
  (constraints-per-review, n_reviews) — the `/debug/routez` table
  ``bench.py obs_engine`` reads the route frontier from;
- tier flips (chosen tier != previous decision's) feed the flight
  recorder (obs/flightrec.py route_flip), bounded by the ring there.

Recording is one lock + deque append + dict add per BATCH (not per
review); the ``enabled`` flag exists so `bench.py obs_engine` can
measure the plane's cost with paired on/off arms.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

#: tier-win shapes tracked before overflow coalescing (a shape is a
#: (per-review cells, n_reviews) pair; real corpora produce dozens)
MAX_SHAPES = 512

_DEFAULT_RING = 256

#: reasons record() accepts — documented above and in
#: docs/observability.md; an unknown reason is still recorded (the
#: ledger must never lose an incident to taxonomy drift)
REASONS = (
    "forced_device",
    "uncalibrated_prior",
    "latency",
    "load_aware",
    "saturated",
    "brownout_pin",
    "breaker_open",
    "compile_pending",
    "device_failed",
    # a referential (cross-resource join) audit sweep dispatched through
    # the vectorized join kernels (ops/joinkernel.py) — recorded so join
    # dispatches are never misattributed to the row-local tiers
    "join_plan",
)


class RouteLedger:
    def __init__(self, maxlen: int = _DEFAULT_RING):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(maxlen), 16))
        self._seq = 0
        self.enabled = True
        self._driver_ref: Optional[weakref.ref] = None
        # (per_review_cells, n_reviews) -> {tier: count}
        self._tier_wins: Dict[Tuple[int, int], Dict[str, int]] = {}
        self._shape_overflow = 0
        self._counts: Dict[Tuple[str, str], int] = {}
        self._last_tier: Optional[str] = None
        self.flips = 0
        #: newest decision's (tier, reason) — assigned atomically so the
        #: decision log reads it lock-free per admission record
        self.last_decision: Optional[Tuple[str, str]] = None

    def attach(self, driver) -> "RouteLedger":
        """Bind the owning driver (weakly: test suites create hundreds of
        drivers) so snapshots can serve its live calibration."""
        self._driver_ref = weakref.ref(driver)
        return self

    # ---- recording ---------------------------------------------------------

    def record(self, tier: str, reason: str, cells: int, n_reviews: int,
               lam: Optional[float], priced: Optional[List[dict]] = None,
               track_flips: bool = True):
        """One routing decision.  Guarded: the ledger must never fail the
        evaluation it describes.  ``track_flips=False`` records the entry
        and counters without touching the serving-tier flip tracker —
        audit-class dispatches (join_plan sweeps) interleave with review
        traffic and would otherwise fabricate a route_flip incident event
        per audit interval."""
        if not self.enabled:
            return
        try:
            self._record(tier, reason, cells, n_reviews, lam, priced,
                         track_flips)
        except Exception:
            from ..metrics.catalog import record_dropped

            record_dropped("routeledger.record")

    def _record(self, tier, reason, cells, n_reviews, lam, priced,
                track_flips=True):
        per_review = max(int(cells) // max(int(n_reviews), 1), 1)
        entry = {
            "t": round(time.time(), 6),  # wall-clock: ok (render stamp)
            "cells": int(cells),
            "n_reviews": int(n_reviews),
            "per_review_cells": per_review,
            "lam": round(lam, 3) if lam else None,
            "tier": tier,
            "reason": reason,
        }
        if priced:
            entry["priced"] = priced
        flipped = None
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)
            shape = (per_review, int(n_reviews))
            wins = self._tier_wins.get(shape)
            if wins is None:
                if len(self._tier_wins) >= MAX_SHAPES:
                    self._shape_overflow += 1
                else:
                    wins = self._tier_wins[shape] = {}
            if wins is not None:
                wins[tier] = wins.get(tier, 0) + 1
            key = (tier, reason)
            self._counts[key] = self._counts.get(key, 0) + 1
            self.last_decision = (tier, reason)
            if track_flips:
                if self._last_tier is not None and self._last_tier != tier:
                    flipped = (self._last_tier, tier)
                    self.flips += 1
                self._last_tier = tier
        from ..metrics.catalog import record_route_decision

        record_route_decision(tier, reason)
        if flipped is not None:
            from . import flightrec

            flightrec.record(
                flightrec.ROUTE_FLIP,
                from_tier=flipped[0], to_tier=flipped[1],
                reason=reason, cells=int(cells), n_reviews=int(n_reviews),
            )

    # ---- retrieval ---------------------------------------------------------

    def last(self) -> Optional[Tuple[str, str]]:
        """The newest decision's (tier, reason), or None before any —
        the decision log stamps this onto each admission record as the
        route attribution of the batch that served it
        (obs/decisionlog.py)."""
        return self.last_decision

    def tier_wins(self) -> List[dict]:
        """The per-shape tier-win table, smallest shape first."""
        with self._lock:
            shapes = sorted(self._tier_wins.items())
            return [
                {
                    "per_review_cells": c,
                    "n_reviews": r,
                    "cells": c * r,
                    "wins": dict(wins),
                }
                for (c, r), wins in shapes
            ]

    def snapshot(self, limit: Optional[int] = None) -> dict:
        """The `/debug/routez` payload: recent decisions (newest last),
        the tier-win table, decision counts by (tier, reason), and the
        owning driver's live calibration + service-model curves."""
        with self._lock:
            decisions = list(self._ring)
            counts = {
                f"{tier}|{reason}": n
                for (tier, reason), n in sorted(self._counts.items())
            }
            overflow = self._shape_overflow
            flips = self.flips
        if limit is not None and limit >= 0:
            # limit=0 means none — a bare [-0:] would return everything
            decisions = decisions[-limit:] if limit else []
        out = {
            "decisions": decisions,
            "tier_wins": self.tier_wins(),
            "tier_wins_overflow": overflow,
            "counts": counts,
            "flips": flips,
            "enabled": self.enabled,
        }
        driver = self._driver_ref() if self._driver_ref is not None else None
        cal = getattr(driver, "_route_cal", None) if driver is not None \
            else None
        out["calibration"] = dict(cal) if cal else None
        if driver is not None and hasattr(driver, "join_plan_shapes"):
            try:
                shapes = driver.join_plan_shapes()
            except Exception:
                from ..metrics.catalog import record_dropped

                record_dropped("routeledger.join_plan_shapes")
                shapes = []
            if shapes:
                # referential workloads: the join-plan table (aggregate
                # family, provider kind/scope, live group/provider/reader
                # counts) so /debug/routez explains join_plan dispatches
                out["join_plans"] = shapes
        if driver is not None and cal:
            # the live service-model curves over a per-review-cells grid:
            # predicted single-batch latency per tier — the crossover plot
            # an operator reads the frontier from without re-deriving the
            # affine model
            curves = {}
            for n in (1, 10, 100, 1000, 10000):
                try:
                    models = driver._tier_models(n)
                except Exception:
                    break
                curves[str(n)] = {
                    tier: round(floor + per_ms, 6)
                    for tier, floor, per_ms in models
                }
            out["curves_ms_per_review"] = curves
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._tier_wins.clear()
            self._counts.clear()
            self._shape_overflow = 0
            self._last_tier = None
            self.flips = 0
            self.last_decision = None


# the most recently attached ledger, weakly held: `/debug/routez` serves
# the live App's driver in production; in test suites (many short-lived
# drivers) whichever was constructed last wins, and a collected driver
# leaves the endpoint empty instead of leaking it
_ACTIVE: Optional[weakref.ref] = None


def set_active(ledger: RouteLedger):
    global _ACTIVE
    _ACTIVE = weakref.ref(ledger)


def get_active() -> Optional[RouteLedger]:
    return _ACTIVE() if _ACTIVE is not None else None
