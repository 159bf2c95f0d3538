"""Circuit breaker for the TPU evaluation backend.

Wraps the driver's compile/dispatch seams: after `failure_threshold`
CONSECUTIVE backend failures the breaker trips OPEN and the driver serves
every evaluation from the inherited interpreter tier (semantically
identical — the device mask is only ever a pruning over-approximation of
the interpreter walk).  While open, a background probe thread re-tries a
tiny real dispatch on a fixed cadence (half-open); one probe success
closes the breaker and evaluation returns to the device.  Without a
probe_fn the breaker degrades to lazy half-open: after `cooldown_s` the
next real call is admitted as the trial.

State is exported through `status()` (driver -> metrics catalog + the
webhook health endpoint): state, trip count, consecutive failures, and
cumulative seconds spent degraded.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 5.0,
        probe_fn: Optional[Callable[[], None]] = None,
        probe_interval_s: Optional[float] = None,
        on_transition: Optional[Callable[[str, str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = cooldown_s
        self.probe_fn = probe_fn
        self.probe_interval_s = (
            probe_interval_s if probe_interval_s is not None else cooldown_s
        )
        self.on_transition = on_transition
        self._clock = clock
        # RLock: transition hooks run under the lock and may read status()
        self._lock = threading.RLock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._trips = 0
        # _opened_at paces the cooldown (reset on every re-open);
        # _degraded_since anchors the degraded-time metric (set once on
        # leaving CLOSED, cleared only on return to CLOSED) — a failed
        # half-open trial must NOT zero accumulated degradation
        self._opened_at: Optional[float] = None
        self._degraded_since: Optional[float] = None
        self._degraded_s = 0.0  # cumulative, completed degraded intervals
        self._trial_inflight = False
        self._last_error: Optional[str] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_wake = threading.Event()
        # True once the probe thread has DECIDED to exit (set under the
        # lock): a trip landing between that decision and the thread's
        # return must start a fresh thread, not signal a dying one
        self._probe_exiting = True

    # ---- state machine -----------------------------------------------------

    def _set_state(self, new: str):
        """Caller holds the lock."""
        old = self._state
        if old == new:
            return
        now = self._clock()
        if old == CLOSED:
            self._opened_at = now
            self._degraded_since = now
        if new == CLOSED:
            if self._degraded_since is not None:
                self._degraded_s += now - self._degraded_since
            self._opened_at = None
            self._degraded_since = None
        self._state = new
        self._notify(old, new)

    def allow(self) -> bool:
        """May the caller attempt a device operation right now?"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if (
                self._state == OPEN
                and self.probe_fn is None
                and self._opened_at is not None
                and self._clock() - self._opened_at >= self.cooldown_s
            ):
                # lazy half-open: no background prober, so real traffic
                # supplies the trial call
                self._set_state(HALF_OPEN)
            if self._state == HALF_OPEN and not self._trial_inflight:
                self._trial_inflight = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._trial_inflight = False
            self._consecutive_failures = 0
            self._last_error = None
            if self._state != CLOSED:
                self._set_state(CLOSED)

    def record_failure(self, error: Optional[BaseException] = None):
        with self._lock:
            self._trial_inflight = False
            self._consecutive_failures += 1
            if error is not None:
                self._last_error = f"{type(error).__name__}: {error}"
            if self._state == HALF_OPEN:
                # failed trial: back to open, restarting the COOLDOWN
                # clock only — _degraded_since keeps the original anchor
                # (degraded-seconds spans the whole outage) and _trips is
                # NOT incremented (trips count closed->open transitions,
                # i.e. distinct incidents, not failed recovery probes)
                self._state = OPEN
                self._opened_at = self._clock()
                self._notify(HALF_OPEN, OPEN)
            elif (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._trips += 1
                self._set_state(OPEN)
                self._start_probe_locked()

    def _notify(self, old: str, new: str):
        hook = self.on_transition
        if hook is not None:
            try:
                hook(old, new)
            except Exception:
                # a transition-hook defect must not wedge the breaker's
                # state machine, but losing a degradation signal (mesh
                # re-shard, SLO trip) silently would be worse — log it;
                # transitions are rare so this cannot spam
                import logging

                logging.getLogger("gatekeeper.breaker").warning(
                    "breaker transition hook failed (%s -> %s)", old, new,
                    exc_info=True,
                )

    def trip(self):
        """Force the breaker open (tests / admin)."""
        with self._lock:
            if self._state == CLOSED:
                self._trips += 1
                self._set_state(OPEN)
                self._start_probe_locked()

    # ---- recovery probes ---------------------------------------------------

    def _start_probe_locked(self):
        if self.probe_fn is None:
            return
        t = self._probe_thread
        if t is not None and t.is_alive() and not self._probe_exiting:
            self._probe_wake.set()
            return
        self._probe_exiting = False
        self._probe_wake.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="tpu-breaker-probe", daemon=True
        )
        self._probe_thread.start()

    def _probe_loop(self):
        """Half-open recovery on a background cadence: the thread lives
        only while the breaker is degraded.  The exit decision is made
        ONLY at the top of the loop under the lock (setting
        _probe_exiting in the same critical section), so a trip racing a
        successful probe either reaches this still-live thread or sees
        _probe_exiting and starts a fresh one — never neither."""
        while True:
            self._probe_wake.wait(self.probe_interval_s)
            self._probe_wake.clear()
            with self._lock:
                if self._state == CLOSED:
                    self._probe_exiting = True
                    return
                # refresh transition-hook consumers (metrics gauges) while
                # the outage lasts: degraded_seconds would otherwise stay
                # frozen at its trip-time value for the whole outage
                self._notify(self._state, self._state)
                if (
                    self._opened_at is not None
                    and self._clock() - self._opened_at < self.cooldown_s
                ):
                    continue
                self._set_state(HALF_OPEN)
                self._trial_inflight = True
            try:
                self.probe_fn()
            except Exception as e:
                self.record_failure(e)
            else:
                self.record_success()
                # loop once more: the CLOSED check above decides exit
                # under the lock, so a trip landing right now is not
                # orphaned

    def probe_now(self) -> bool:
        """Run one synchronous recovery probe (deterministic tests).
        Returns True when the probe closed the breaker."""
        if self.probe_fn is None:
            return False
        with self._lock:
            if self._state == CLOSED:
                return True
            self._set_state(HALF_OPEN)
            self._trial_inflight = True
        try:
            self.probe_fn()
        except Exception as e:
            self.record_failure(e)
            return False
        self.record_success()
        return True

    # ---- introspection -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def trips(self) -> int:
        with self._lock:
            return self._trips

    def status(self) -> dict:
        with self._lock:
            degraded = self._degraded_s
            if self._degraded_since is not None:
                degraded += self._clock() - self._degraded_since
            return {
                "state": self._state,
                "state_code": STATE_CODES[self._state],
                "trips": self._trips,
                "consecutive_failures": self._consecutive_failures,
                "degraded_seconds": round(degraded, 6),
                "last_error": self._last_error,
            }
