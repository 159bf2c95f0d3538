"""Declarative SLO objectives with multi-window burn-rate gauges.

The engine tracks three kinds of signal against declared objectives:

- **event streams** — good/bad outcomes recorded as they happen (the
  webhook feeds admission latency and fail-closed error outcomes from
  ``ValidationHandler.handle``'s existing accounting);
- **probes** — point-in-time checks sampled whenever the engine is
  evaluated (a /metrics scrape, /debug/slo, /statusz), used for
  continuous conditions like audit freshness;
- **anchors** — the audit manager marks each successful sweep, from
  which the ``audit_last_run_age_s`` gauge and the freshness probe
  derive.

Burn rate is the standard error-budget consumption speed: with objective
target t (good fraction), budget = 1 - t and

    burn(window) = bad_fraction(window) / budget

1.0 means the budget is being consumed exactly at the sustainable rate;
the multi-window, multi-burn-rate alerts follow the SRE-workbook pairs:

    fast:  burn(5m)  >= 14.4  AND  burn(1h) >= 14.4   (~2% budget/hour)
    slow:  burn(30m) >= 6.0   AND  burn(6h) >= 6.0    (~5% budget/6h)

State is monotonic-clock time buckets (60s wide, 6h retained) under one
lock; recording is a dict lookup + two int adds.  Surfaces: the
``gatekeeper_slo_*`` gauges via :func:`collect_hook`, ``/debug/slo``
(obs/debug.py), ``/statusz`` (wired through the webhook server's
health_status callable), and ``on_alert`` callbacks — the degradation
signal ``--slo-trip-breaker`` feeds to the TPU circuit breaker.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..metrics.catalog import record_dropped as _record_dropped

# window name -> seconds; PAIRS are (name, short, long, threshold)
WINDOWS: Dict[str, float] = {
    "5m": 300.0, "30m": 1800.0, "1h": 3600.0, "6h": 21600.0,
}
PAIRS = (
    ("fast", "5m", "1h", 14.4),
    ("slow", "30m", "6h", 6.0),
)
_BUCKET_S = 60.0
_RETAIN_S = max(WINDOWS.values())

ADMISSION_LATENCY = "admission_latency"
FAIL_CLOSED_ERRORS = "fail_closed_errors"
AUDIT_FRESHNESS = "audit_freshness"
EDGE_LATENCY = "edge_latency"


class Objective:
    __slots__ = ("name", "target", "description", "probe")

    def __init__(self, name: str, target: float, description: str = "",
                 probe: Optional[Callable[[], bool]] = None):
        if not 0.0 < target < 1.0:
            raise ValueError(f"objective {name}: target must be in (0, 1)")
        self.name = name
        self.target = float(target)
        self.description = description
        self.probe = probe

    @property
    def budget(self) -> float:
        return 1.0 - self.target


class SLOEngine:
    def __init__(self, clock=time.monotonic, bucket_s: float = _BUCKET_S):
        self._clock = clock
        self._bucket_s = float(bucket_s)
        self._lock = threading.Lock()
        self._objectives: Dict[str, Objective] = {}
        # name -> deque of [bucket_idx, good, bad]
        self._series: Dict[str, deque] = {}
        self._started = clock()
        self._audit_anchor: Optional[float] = None
        self._alerts_active: set = set()  # (objective, pair) pairs firing
        self._on_alert: List[Callable[[str, str], None]] = []
        # config consulted by the module-level observers
        self.admission_threshold_s = 0.100
        # edge-latency good/bad split: a reactor heartbeat skew sample
        # above this reads as the serving edge adding user-visible
        # latency (the loop was busy when the timer was due)
        self.edge_threshold_s = 0.050
        self.audit_max_age_s = 300.0
        # alert volume floor: a burn alert needs at least this many
        # events in the pair's SHORT window — 1 bad event out of 2 must
        # not page anyone (burn rates themselves are still reported)
        self.min_alert_events = 10
        # False on processes not assigned the audit operation: the
        # freshness probe then always reports good and the age gauge is
        # withheld — a webhook-only pod must not read as degraded
        # because a sweep it will never run "is stale"
        self.audit_expected = True

    # ---- declaration -------------------------------------------------------

    def add_objective(self, name: str, target: float, description: str = "",
                      probe: Optional[Callable[[], bool]] = None):
        with self._lock:
            self._objectives[name] = Objective(
                name, target, description, probe
            )
            self._series.setdefault(name, deque())

    def objectives(self) -> List[str]:
        with self._lock:
            return list(self._objectives)

    def on_alert(self, cb: Callable[[str, str], None]):
        """Register cb(objective_name, pair_name), fired when a burn
        alert ACTIVATES (edge-triggered) during evaluate()."""
        self._on_alert.append(cb)

    # ---- recording ---------------------------------------------------------

    def record(self, name: str, good: bool, n: int = 1):
        if n <= 0:
            return
        idx = int(self._clock() // self._bucket_s)
        with self._lock:
            series = self._series.get(name)
            if series is None:
                return  # undeclared objective: drop, never raise
            if not series or series[-1][0] != idx:
                series.append([idx, 0, 0])
                horizon = idx - int(_RETAIN_S // self._bucket_s) - 1
                while series and series[0][0] < horizon:
                    series.popleft()
            if good:
                series[-1][1] += n
            else:
                series[-1][2] += n

    def observe_audit_run(self):
        """Mark a successful audit sweep (freshness anchor)."""
        with self._lock:
            self._audit_anchor = self._clock()

    def audit_age_s(self) -> float:
        """Seconds since the last successful sweep — since engine start
        when none has completed yet (a never-running audit must look
        stale, not fresh)."""
        with self._lock:
            anchor = (
                self._audit_anchor if self._audit_anchor is not None
                else self._started
            )
            return max(0.0, self._clock() - anchor)

    # ---- math --------------------------------------------------------------

    def _counts(self, name: str, window_s: float) -> tuple:
        """(good, bad) over the trailing window.  Caller holds the lock."""
        horizon = int(self._clock() // self._bucket_s) - int(
            window_s // self._bucket_s
        )
        good = bad = 0
        for idx, g, b in self._series.get(name, ()):
            if idx >= horizon:
                good += g
                bad += b
        return good, bad

    def burn_rates(self, name: str) -> Dict[str, float]:
        """{window: burn rate} for one objective.  Zero traffic in a
        window means zero burn (no events cannot consume budget)."""
        with self._lock:
            obj = self._objectives.get(name)
            if obj is None:
                return {}
            out = {}
            for wname, ws in WINDOWS.items():
                good, bad = self._counts(name, ws)
                total = good + bad
                frac = (bad / total) if total else 0.0
                out[wname] = round(frac / obj.budget, 4)
            return out

    # ---- evaluation --------------------------------------------------------

    def evaluate(self) -> dict:
        """Run probes (each records one sample), compute burn rates and
        alerts, fire edge-triggered on_alert callbacks, and return the
        /debug/slo // /statusz payload."""
        with self._lock:
            probed = [
                (o.name, o.probe) for o in self._objectives.values()
                if o.probe is not None
            ]
        for name, probe in probed:
            try:
                self.record(name, bool(probe()))
            except Exception:
                self.record(name, False)  # a failing probe is a bad sample
        objectives = {}
        newly = []
        cleared = []
        with self._lock:
            objs = list(self._objectives.values())
        for obj in objs:
            rates = self.burn_rates(obj.name)
            alerts = {}
            for pname, short, long_, threshold in PAIRS:
                with self._lock:
                    sg, sb = self._counts(obj.name, WINDOWS[short])
                firing = (
                    sg + sb >= self.min_alert_events
                    and rates.get(short, 0.0) >= threshold
                    and rates.get(long_, 0.0) >= threshold
                )
                alerts[pname] = firing
                key = (obj.name, pname)
                with self._lock:
                    was = key in self._alerts_active
                    if firing and not was:
                        self._alerts_active.add(key)
                        newly.append(key)
                    elif not firing and was:
                        self._alerts_active.discard(key)
                        cleared.append(key)
            with self._lock:
                good6, bad6 = self._counts(obj.name, WINDOWS["6h"])
            total6 = good6 + bad6
            consumed = (
                (bad6 / total6) / obj.budget if total6 else 0.0
            )
            objectives[obj.name] = {
                "description": obj.description,
                "target": obj.target,
                "burn_rates": rates,
                "alerts": alerts,
                "events_6h": total6,
                "budget_remaining": round(max(0.0, 1.0 - consumed), 4),
            }
        out = {
            "objectives": objectives,
            "audit_last_run_age_s": round(self.audit_age_s(), 3),
            "degraded": sorted(
                {name for (name, _p) in self._alerts_active}
            ),
        }
        # fleet identity: each replica runs its OWN engine over its own
        # traffic, so /statusz + /debug/slo payloads from N replicas
        # stay attributable when an aggregator merges them
        from ..util import replica_id

        rid = replica_id()
        if rid:
            out["replica_id"] = rid
        # flight recorder (obs/flightrec.py): burn-alert EDGES are
        # incident chronology; an activation is a page, so it also dumps
        # the ring — the artifact then spans cause (shed bursts, breaker
        # trips) and effect (the page) in one causal order
        if newly or cleared:
            try:
                from . import flightrec

                for name, pair in newly:
                    flightrec.record(
                        flightrec.SLO_ALERT, objective=name, pair=pair,
                        edge="activated",
                        burn_rates=objectives.get(name, {}).get(
                            "burn_rates"),
                    )
                for name, pair in cleared:
                    flightrec.record(
                        flightrec.SLO_ALERT, objective=name, pair=pair,
                        edge="cleared",
                    )
                if newly:
                    flightrec.dump("slo_page")
            except Exception:  # the recorder must never break evaluation
                _record_dropped("slo.flightrec")
        for key in newly:
            for cb in list(self._on_alert):
                try:
                    cb(*key)
                except Exception:
                    # a consumer defect must not break evaluation — but an
                    # alert that silently went nowhere is an incident
                    # nobody paged on; alerts are edge-triggered so this
                    # cannot spam
                    import logging

                    logging.getLogger("gatekeeper.slo").warning(
                        "SLO alert consumer failed for %s", key,
                        exc_info=True,
                    )
        return out

    def degraded(self) -> bool:
        """Any burn alert currently firing — the breaker-facing signal."""
        with self._lock:
            return bool(self._alerts_active)

    # ---- metrics export ----------------------------------------------------

    def collect(self, registry) -> None:
        """Record slo_burn_rate / slo_error_budget_remaining /
        audit_last_run_age_s gauges (MetricsExporter pre-scrape hook)."""
        from ..metrics import catalog as cat

        cat.register_catalog(registry)
        st = self.evaluate()
        for name, o in st["objectives"].items():
            for window, rate in o["burn_rates"].items():
                registry.record(
                    cat.SLO_BURN_M, rate,
                    {"objective": name, "window": window},
                )
            registry.record(
                cat.SLO_BUDGET_M, o["budget_remaining"],
                {"objective": name},
            )
        if self.audit_expected:
            registry.record(cat.AUDIT_AGE_M, st["audit_last_run_age_s"])

    def clear(self):
        with self._lock:
            for series in self._series.values():
                series.clear()
            self._alerts_active.clear()
            self._audit_anchor = None
            self._started = self._clock()


def default_engine(clock=time.monotonic) -> SLOEngine:
    """An engine with the three stock objectives declared."""
    eng = SLOEngine(clock=clock)
    eng.add_objective(
        ADMISSION_LATENCY, 0.999,
        "fraction of admission requests answered within the latency "
        "threshold (--slo-admission-latency-ms)",
    )
    eng.add_objective(
        FAIL_CLOSED_ERRORS, 0.999,
        "fraction of admission requests not answered by the error path "
        "(fail-open/closed decisions, internal errors)",
    )
    eng.add_objective(
        EDGE_LATENCY, 0.999,
        "fraction of event-edge reactor heartbeat skew samples under the "
        "edge latency threshold (loop-lag stays invisible to clients)",
    )
    eng.add_objective(
        AUDIT_FRESHNESS, 0.999,
        "fraction of freshness probes with the last successful audit "
        "sweep younger than --slo-audit-max-age-s",
        probe=lambda: (
            not eng.audit_expected
            or eng.audit_age_s() <= eng.audit_max_age_s
        ),
    )
    return eng


_ENGINE = default_engine()


def get_engine() -> SLOEngine:
    return _ENGINE


def configure(
    admission_threshold_ms: Optional[float] = None,
    admission_target: Optional[float] = None,
    error_target: Optional[float] = None,
    audit_max_age_s: Optional[float] = None,
    audit_target: Optional[float] = None,
    audit_expected: Optional[bool] = None,
):
    eng = _ENGINE
    if admission_threshold_ms is not None:
        eng.admission_threshold_s = float(admission_threshold_ms) / 1e3
    if audit_max_age_s is not None:
        eng.audit_max_age_s = float(audit_max_age_s)
    if audit_expected is not None:
        eng.audit_expected = bool(audit_expected)
    for name, target in (
        (ADMISSION_LATENCY, admission_target),
        (FAIL_CLOSED_ERRORS, error_target),
        (AUDIT_FRESHNESS, audit_target),
    ):
        if target is None:
            continue
        with eng._lock:
            old = eng._objectives[name]
            # re-declare through Objective so the (0, 1) validation
            # runs: a --slo-*-target typo (1.0, or 99.9 meaning percent)
            # must fail loudly at startup, not zero the budget and crash
            # every later evaluate()
            eng._objectives[name] = Objective(
                name, float(target), old.description, old.probe
            )


def observe_admission(status: str, duration_s: float):
    """Feed one admission outcome (called from ValidationHandler.handle's
    existing finally block — no new timing).  Guarded: SLO accounting
    must never fail the request being measured."""
    try:
        _ENGINE.record(
            ADMISSION_LATENCY, duration_s <= _ENGINE.admission_threshold_s
        )
        _ENGINE.record(FAIL_CLOSED_ERRORS, status != "error")
    except Exception:  # telemetry never blocks eval
        _record_dropped("slo.observe_admission")


def observe_audit_run():
    try:
        _ENGINE.observe_audit_run()
    except Exception:  # telemetry never blocks audit
        _record_dropped("slo.observe_audit_run")


def observe_edge_latency(lag_s: float):
    """Feed one reactor loop-lag sample (heartbeat skew, measured on the
    loop itself by obs/reactorobs.py) into the edge-latency objective.
    Guarded: SLO accounting must never wedge the reactor."""
    try:
        _ENGINE.record(EDGE_LATENCY, lag_s <= _ENGINE.edge_threshold_s)
    except Exception:  # telemetry never blocks the loop
        _record_dropped("slo.observe_edge_latency")


def collect_hook(registry):
    try:
        _ENGINE.collect(registry)
    except Exception:  # telemetry never blocks scrape
        _record_dropped("slo.collect_hook")
