"""The brownout ladder: sustained-overload degradation with hysteresis
(docs/failure-modes.md overload section).

Shedding (bounded queues, the front door's 429s) protects the admission
path *request by request*; the brownout controller protects it
*structurally*: while overload is sustained, everything that competes
with admissions for the same cores steps aside — reversibly, one rung
at a time, and back again when pressure clears.

Ladder levels (each includes the ones above it):

    0  normal
    1  defer audit sweeps and snapshotter arming (the audit loop and
       the snapshot writer consult `defer_background()` each cycle)
    2  + drop trace sampling and the profiler rate (telemetry keeps its
       bounded rings; it just samples less while the box is saturated)
    3  + pin the evaluation router to the cheapest SUSTAINABLE tier
       (TpuDriver.set_brownout_pin: max-throughput routing regardless of
       per-batch latency — drain the queue first, optimize p50 later)

The overload signal is a composite the controller samples on its own
daemon thread (`tick_s` cadence) from injected providers:

  - **queue depth** — the micro-batcher's pending fraction
    (len(pending) / max_pending);
  - **shed rate** — a decayed per-second rate of `shed_total`
    recordings (`note_shed`, fed by metrics.catalog.record_shed from
    every shed site: batcher bound, door inflight, expired deadlines);
  - **SLO burn** — the SLO engine's fast-burn degradation flag;
  - **loop lag** — the event edge's reactor heartbeat skew
    (obs/reactorobs.py): a lagging loop means admissions queue at the
    socket edge before any other signal can see them.

Hysteresis both ways: a step UP requires the overload predicate to hold
for `up_after_s` continuously; a step DOWN requires the *clear*
predicate (a strictly lower bar — queue below `queue_low`, shed rate
below `shed_low`, no SLO burn) to hold for `down_after_s`.  Between the
two bars the ladder holds.  Every transition is edge-logged with the
signal snapshot and recorded as the `brownout_level` gauge; the current
level also rides the `/statusz` payload (main.App health_status).

The module-global controller (`get_controller()`) exists so shed sites
can feed it without wiring; it only *acts* once `App.start` attaches
providers/actions and starts the sampler.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from .. import logging as gklog
from ..metrics.catalog import record_brownout_level
from ..util import join_thread

log = gklog.get("obs.brownout")

#: highest ladder rung
MAX_LEVEL = 3
#: rung semantics (docs/failure-modes.md) — index = level
LEVELS = (
    "normal",
    "defer-audit",
    "reduce-telemetry",
    "pin-throughput-routing",
)


class BrownoutController:
    # signal thresholds (class-level so tests can tune)
    QUEUE_HIGH = 0.75     # pending fraction that reads as overload
    QUEUE_LOW = 0.25      # pending fraction that reads as clear
    SHED_HIGH = 1.0       # sheds/s that read as overload
    SHED_LOW = 0.1        # sheds/s that read as clear
    LAG_HIGH = 0.25       # reactor loop-lag (s) that reads as overload
    LAG_LOW = 0.05        # reactor loop-lag (s) that reads as clear
    UP_AFTER_S = 1.0      # overload must hold this long to step up
    DOWN_AFTER_S = 5.0    # clear must hold this long to step down
    TICK_S = 0.25         # sampler cadence
    SHED_DECAY_S = 2.0    # shed-rate EWMA time constant

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.level = 0
        # providers (None = signal absent, reads as not-overloaded)
        self._queue_frac: Optional[Callable[[], float]] = None
        self._slo_degraded: Optional[Callable[[], bool]] = None
        self._loop_lag: Optional[Callable[[], float]] = None
        # decayed shed rate, fed cross-thread by note_shed()
        self._shed_count = 0
        self._shed_rate = 0.0
        self._shed_t = clock()
        # hysteresis clocks: when the current streak started (None = the
        # predicate does not currently hold)
        self._over_since: Optional[float] = None
        self._clear_since: Optional[float] = None
        self._on_change: List[Callable[[int, int], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.transitions = 0  # total ladder steps (both directions)
        self.last_signals: dict = {}

    # ---- wiring ------------------------------------------------------------

    def set_providers(self, queue_frac: Optional[Callable[[], float]] = None,
                      slo_degraded: Optional[Callable[[], bool]] = None,
                      loop_lag: Optional[Callable[[], float]] = None):
        with self._lock:
            if queue_frac is not None:
                self._queue_frac = queue_frac
            if slo_degraded is not None:
                self._slo_degraded = slo_degraded
            if loop_lag is not None:
                self._loop_lag = loop_lag
        return self

    def on_change(self, cb: Callable[[int, int], None]):
        """Register cb(old_level, new_level), fired OUTSIDE the lock on
        every ladder transition (actions may touch other subsystems'
        locks — tracer, profiler, driver)."""
        self._on_change.append(cb)
        return self

    def clear_actions(self):
        """Drop registered actions (App restarts re-wire against the
        process-global controller; stacking the old App's closures would
        double-apply every degradation)."""
        self._on_change.clear()

    # ---- signals -----------------------------------------------------------

    def note_shed(self, n: int = 1):
        """One (or n) shed requests — called from every shed site via
        metrics.catalog.record_shed.  Cheap: an int add under the lock;
        the decay happens on the sampler tick."""
        with self._lock:
            self._shed_count += n

    def shed_rate(self) -> float:
        with self._lock:
            return self._shed_rate

    def _roll_shed_rate_locked(self, now: float) -> float:
        dt = now - self._shed_t
        if dt <= 0:
            return self._shed_rate
        inst = self._shed_count / dt
        # EWMA with a time constant: alpha -> 1 for long gaps, so a
        # stale burst decays instead of pinning the ladder up
        alpha = min(dt / self.SHED_DECAY_S, 1.0)
        self._shed_rate = (1.0 - alpha) * self._shed_rate + alpha * inst
        self._shed_count = 0
        self._shed_t = now
        return self._shed_rate

    # ---- the ladder --------------------------------------------------------

    def defer_background(self) -> bool:
        """Level >= 1: audit sweeps and snapshotter arming step aside.
        Consulted each cycle by AuditManager._loop and
        Snapshotter._loop — deferral is a skipped iteration, so recovery
        needs no re-arm."""
        return self.level >= 1

    def reduce_telemetry(self) -> bool:
        return self.level >= 2

    def pin_routing(self) -> bool:
        return self.level >= 3

    def tick(self, now: Optional[float] = None):
        """One signal sample + ladder step evaluation.  Called by the
        sampler thread; tests call it directly with a fake clock."""
        now = self._clock() if now is None else now
        cbs_fire: Optional[tuple] = None
        with self._lock:
            shed_rate = self._roll_shed_rate_locked(now)
            qf = self._queue_frac
            slo = self._slo_degraded
            ll = self._loop_lag
        # providers run OUTSIDE the lock: they take other locks (the
        # batcher cv is NOT among them — queue_frac reads a list length
        # — but the SLO engine locks itself)
        queue_frac = 0.0
        if qf is not None:
            try:
                queue_frac = float(qf())
            except Exception:
                log.debug("brownout queue provider failed", exc_info=True)
        slo_burn = False
        if slo is not None:
            try:
                slo_burn = bool(slo())
            except Exception:
                log.debug("brownout SLO provider failed", exc_info=True)
        loop_lag = 0.0
        if ll is not None:
            try:
                loop_lag = float(ll())
            except Exception:
                log.debug("brownout loop-lag provider failed",
                          exc_info=True)
        overloaded = (
            queue_frac >= self.QUEUE_HIGH
            or shed_rate >= self.SHED_HIGH
            or slo_burn
            or loop_lag >= self.LAG_HIGH
        )
        clear = (
            queue_frac <= self.QUEUE_LOW
            and shed_rate <= self.SHED_LOW
            and not slo_burn
            and loop_lag <= self.LAG_LOW
        )
        with self._lock:
            self.last_signals = {
                "queue_frac": round(queue_frac, 4),
                "shed_rate": round(shed_rate, 3),
                "slo_burn": slo_burn,
                "loop_lag": round(loop_lag, 4),
            }
            if overloaded:
                self._clear_since = None
                if self._over_since is None:
                    self._over_since = now
                if (
                    self.level < MAX_LEVEL
                    and now - self._over_since >= self.UP_AFTER_S
                ):
                    cbs_fire = (self.level, self.level + 1)
                    self.level += 1
                    self.transitions += 1
                    self._over_since = now  # one rung per sustained window
            elif clear:
                self._over_since = None
                if self._clear_since is None:
                    self._clear_since = now
                if (
                    self.level > 0
                    and now - self._clear_since >= self.DOWN_AFTER_S
                ):
                    cbs_fire = (self.level, self.level - 1)
                    self.level -= 1
                    self.transitions += 1
                    self._clear_since = now  # one rung per clear window
            else:
                # between the bars: hold the rung, reset both streaks —
                # hysteresis means NEITHER direction may accumulate here
                self._over_since = None
                self._clear_since = None
        if cbs_fire is not None:
            old, new = cbs_fire
            record_brownout_level(new)
            gklog.log_event(
                log,
                f"brownout ladder {'+' if new > old else '-'} "
                f"level {old} -> {new} ({LEVELS[new]})",
                event_type="brownout_step",
                level=new,
                direction="up" if new > old else "down",
                **self.last_signals,
            )
            # flight recorder: ladder edges are incident chronology — a
            # post-mortem reads them interleaved with breaker/shed/route
            # events from ONE artifact (obs/flightrec.py)
            try:
                from . import flightrec

                flightrec.record(
                    flightrec.BROWNOUT_STEP, old=old, new=new,
                    level_name=LEVELS[new], **self.last_signals,
                )
            except Exception:  # the recorder must never break the ladder
                log.debug("brownout flightrec record failed",
                          exc_info=True)
            for cb in list(self._on_change):
                try:
                    cb(old, new)
                except Exception:
                    # an action defect must not break the ladder — but a
                    # degradation that silently didn't apply is an
                    # incident; log loudly, once per transition
                    log.exception(
                        "brownout action failed on %d -> %d", old, new
                    )

    # ---- sampler lifecycle -------------------------------------------------

    def start(self):
        """Idempotent sampler start (the repo's start-guard contract)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        record_brownout_level(self.level)
        self._thread = threading.Thread(
            target=self._run, name="gk-brownout", daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.TICK_S):
            try:
                self.tick()
            except Exception:
                # one bad tick must not kill the ladder
                log.exception("brownout tick failed")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            join_thread(self._thread, 2.0, "brownout sampler")
            self._thread = None

    def status(self) -> dict:
        """The /statusz payload fragment."""
        with self._lock:
            return {
                "level": self.level,
                "level_name": LEVELS[self.level],
                "transitions": self.transitions,
                "signals": dict(self.last_signals),
            }

    def reset(self):
        """Back to level 0 without firing actions (tests, restarts)."""
        with self._lock:
            self.level = 0
            self._over_since = None
            self._clear_since = None
            self._shed_count = 0
            self._shed_rate = 0.0
            self._shed_t = self._clock()


_CONTROLLER = BrownoutController()


def get_controller() -> BrownoutController:
    return _CONTROLLER


def note_shed(n: int = 1):
    """Module-level shed feed (metrics.catalog.record_shed calls this so
    shed sites need no controller handle)."""
    _CONTROLLER.note_shed(n)


def defer_background() -> bool:
    """True while audit sweeps / snapshotter arming should step aside
    (level >= 1) — the one-line check background loops use."""
    return _CONTROLLER.defer_background()
