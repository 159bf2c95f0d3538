"""Reactor flight deck: loop-lag, slow-callback attribution
and a cross-thread stall watchdog for the event edge.

The `evloopsafety` static rule keeps *known-blocking* calls off the
reactor; this module is its runtime companion — it catches the stalls
the linter cannot see (a CPU-bound JSON parse, a C extension holding
the GIL, a surprise DNS lookup inside a library) and names the culprit.

Three cooperating pieces:

- :class:`ReactorTelemetry` — the per-loop sink an
  :class:`~gatekeeper_tpu_torch.fleet.evloop.EventLoop` dispatches into
  (``loop.set_telemetry(sink)``).  The loop splits every tick into
  select-wait vs. callback-work (the **loop-utilization** gauge),
  counts callbacks per tick, reports timer-wheel drift, and calls
  ``slow(fn, kind, dur)`` for any callback over ``slow_s`` — which
  lands in a bounded top-K **culprit table** (qualname + conn class)
  and emits an ``evloop_stall`` flight-recorder event.  Per-tick costs
  are plain attribute arithmetic; the registry is only touched on the
  ``FLUSH_S`` cadence through prebound batch observers.

- the **heartbeat** — a self-rescheduled ``call_later`` timer whose
  measured skew IS ``evloop_lag_seconds``: if the loop is busy when
  the timer is due, every client response is late by the same amount.
  Each skew sample also feeds the SLO engine's edge-latency stream
  (obs/slo.py ``observe_edge_latency``) and the brownout composite
  (the module-level :func:`max_lag` provider).  The heartbeat is the
  registered fire site for the ``evloop.slow_callback`` and
  ``evloop.stall`` fault points: a latency rule turns the heartbeat
  itself into the slow callback, so chaos drills exercise the real
  attribution and watchdog paths end to end.

- the **watchdog** — one daemon thread for all attached loops.  The
  loop stores a ``(callback, kind, started)`` breadcrumb in
  ``sink.cur`` around every dispatch; when the watchdog sees a
  breadcrumb older than ``stall_budget_s`` it captures the reactor
  thread's stack via ``sys._current_frames()`` (the profiler's fold
  machinery) and dumps a flight-recorder incident — one dump per
  stall episode, so a 10s wedge is one artifact, not two hundred.

The module also keeps the **connection introspection** registry:
doors/listeners register themselves (:func:`register_door`) and
``/debug/connz`` (obs/debug.py) renders their per-connection
snapshots — age, bytes in/out, write backlog, pipelining depth,
parser state, idle time — top-K by backlog.

This module must NOT import ``selectors``: it runs arbitrary-thread
code (the watchdog, flush paths) and stays outside the evloopsafety
socket-call lint on purpose.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import faults
from .. import logging as gklog
from ..metrics.catalog import (
    record_evloop_flush,
    record_evloop_lag,
    record_evloop_slow_callback,
    record_evloop_stall,
)
from ..util import join_thread
from . import flightrec, slo
from .profiler import MAX_DEPTH, _fold_frame

log = gklog.get("obs.reactorobs")

# ---- tuning knobs (module-level so tests and the bench can tighten) --------

SLOW_CALLBACK_S = 0.050   # one callback past this -> attribution + event
STALL_BUDGET_S = 0.250    # breadcrumb older than this -> watchdog dump
HEARTBEAT_S = 0.100       # lag-probe cadence (10 skew samples/s per loop)
FLUSH_S = 0.500           # registry flush cadence for the tick batches
WATCHDOG_TICK_S = 0.050   # watchdog scan cadence
SAMPLE_EVERY = 64         # 1-in-N tick sampling for the histograms
MAX_CULPRITS = 32         # bounded top-K culprit table per loop
MAX_SAMPLES = 256         # per-window histogram sample cap (flush resets)
_EVENT_MIN_GAP_S = 1.0    # per-culprit flight-recorder event rate bound


def _culprit_name(fn) -> str:
    """``qualname + conn class`` for a dispatched callback: bound
    methods carry their receiver's class (the conn that was slow),
    partials unwrap to the wrapped function."""
    inner = getattr(fn, "func", None)       # functools.partial
    if inner is not None:
        fn = inner
    qual = getattr(fn, "__qualname__", None) or repr(fn)
    owner = getattr(fn, "__self__", None)
    if owner is not None:
        return f"{type(owner).__name__}.{qual.rsplit('.', 1)[-1]}"
    return qual


class ReactorTelemetry:
    """Per-loop telemetry sink (the EventLoop ``_telem`` protocol:
    ``slow_s`` / ``cur`` / ``note_drift`` / ``slow`` / ``tick`` /
    ``flush``).  All mutating methods except :meth:`flush` run ON the
    loop thread; readers (watchdog, /fleetz, /debug) come from other
    threads, so the culprit table sits behind a tiny lock and the
    scalar gauges are plain attributes (atomic enough for telemetry).
    """

    def __init__(self, loop, name: Optional[str] = None,
                 slow_s: float = SLOW_CALLBACK_S,
                 stall_budget_s: float = STALL_BUDGET_S,
                 heartbeat_s: float = HEARTBEAT_S):
        self.loop = loop
        self.name = name or getattr(loop, "_name", "evloop")
        self.slow_s = float(slow_s)
        self.stall_budget_s = float(stall_budget_s)
        self.heartbeat_s = float(heartbeat_s)
        # breadcrumb the loop writes around EVERY dispatch; the
        # watchdog reads it cross-thread (tuple write is atomic)
        self.cur: Optional[tuple] = None
        # latest heartbeat skew — THE loop-lag signal
        self.lag = 0.0
        self.utilization = 0.0
        self.ticks = 0
        self.slow_callbacks = 0
        self.stalls = 0
        # tick accumulators (loop thread only)
        self._sum_select = 0.0
        self._sum_work = 0.0
        self._win_ticks = 0
        self._tick_samples: List[float] = []
        self._cb_samples: List[int] = []
        self._drift_samples: List[float] = []
        # perf_counter: the loop stamps ticks with it, so the flush
        # cadence must compare against the same clock
        self._last_flush = time.perf_counter()
        self._flush_lock = threading.Lock()
        # culprit table: name -> [count, total_s, max_s, kind, last_emit]
        self._culprits: Dict[str, list] = {}
        self._clock = threading.Lock()  # culprit-table lock
        self._hb_expected: Optional[float] = None
        self._hb_stop = False

    # ---- loop-side protocol (hot; must never raise) ------------------------

    def note_drift(self, drift_s: float) -> None:
        if len(self._drift_samples) < MAX_SAMPLES:
            self._drift_samples.append(drift_s)

    def slow(self, fn, kind: str, dur_s: float) -> None:
        try:
            self._slow(fn, kind, dur_s)
        except Exception:  # attribution must never wedge the loop
            log.debug("slow-callback attribution failed", exc_info=True)

    def _slow(self, fn, kind: str, dur_s: float) -> None:
        name = _culprit_name(fn)
        now = time.monotonic()
        emit = False
        with self._clock:
            self.slow_callbacks += 1
            row = self._culprits.get(name)
            if row is None:
                if len(self._culprits) >= MAX_CULPRITS:
                    # bounded: evict the least-offending row so a churn
                    # of one-off culprits cannot grow the table
                    victim = min(self._culprits,
                                 key=lambda k: self._culprits[k][1])
                    del self._culprits[victim]
                row = self._culprits[name] = [0, 0.0, 0.0, kind, 0.0]
            row[0] += 1
            row[1] += dur_s
            if dur_s > row[2]:
                row[2] = dur_s
            row[3] = kind
            if now - row[4] >= _EVENT_MIN_GAP_S:
                row[4] = now
                emit = True
        record_evloop_slow_callback(self.name)
        if emit:
            flightrec.record(
                flightrec.EVLOOP_STALL, via="slow_callback",
                loop=self.name, callback=name, kind=kind,
                duration_ms=round(dur_s * 1e3, 3),
            )

    def tick(self, select_s: float, total_s: float, ncb: int,
             now: float) -> None:
        self._sum_select += select_s
        work = total_s - select_s
        if work > 0.0:
            self._sum_work += work
        self.ticks += 1
        self._win_ticks += 1
        # 1-in-N sampling keeps the histograms honest without a list
        # append per tick — but a tick slow enough to matter is ALWAYS
        # sampled, so a single seeded stall cannot dodge the histogram
        if (self._win_ticks % SAMPLE_EVERY == 1
                or total_s >= self.slow_s):
            if len(self._tick_samples) < MAX_SAMPLES:
                self._tick_samples.append(total_s)
            if len(self._cb_samples) < MAX_SAMPLES:
                self._cb_samples.append(ncb)
        if now - self._last_flush >= FLUSH_S:
            self.flush(now)

    def flush(self, now: Optional[float] = None) -> None:
        """Push the window's batches to the registry.  Runs on the loop
        thread each FLUSH_S, and once more from EventLoop.stop() AFTER
        the join — the final tick's partial window must not vanish."""
        with self._flush_lock:
            ticks, self._tick_samples = self._tick_samples, []
            cbs, self._cb_samples = self._cb_samples, []
            drifts, self._drift_samples = self._drift_samples, []
            sel, self._sum_select = self._sum_select, 0.0
            work, self._sum_work = self._sum_work, 0.0
            self._win_ticks = 0
            self._last_flush = time.perf_counter() if now is None else now
        busy = sel + work
        if busy > 0.0:
            self.utilization = work / busy
        if ticks or cbs or drifts or busy > 0.0:
            record_evloop_flush(self.name, self.utilization, ticks, cbs,
                                drifts)

    # ---- the heartbeat -----------------------------------------------------

    def start_heartbeat(self) -> None:
        self._hb_stop = False

        def _arm():
            # call_later is loop-thread-only; arming through
            # call_soon_threadsafe both keeps the timer heap
            # single-threaded and wakes a selector blocked with no
            # timeout
            self._hb_expected = time.monotonic() + self.heartbeat_s
            self.loop.call_later(self.heartbeat_s, self._beat)

        self.loop.call_soon_threadsafe(_arm)

    def stop_heartbeat(self) -> None:
        self._hb_stop = True

    def _beat(self) -> None:
        """The lag probe, ON the loop.  Skew first, reschedule second,
        fault points last — so a seeded latency rule delays the NEXT
        beat (the lag becomes visible) while THIS beat is the slow
        callback the attribution and watchdog must catch."""
        if self._hb_stop:
            return
        now = time.monotonic()
        expected = self._hb_expected
        skew = max(0.0, now - expected) if expected is not None else 0.0
        self.lag = skew
        record_evloop_lag(self.name, skew)
        slo.observe_edge_latency(skew)
        self._hb_expected = now + self.heartbeat_s
        self.loop.call_later(self.heartbeat_s, self._beat)
        if faults.ENABLED:
            faults.fire(faults.EVLOOP_SLOW_CALLBACK, loop=self.name)
            faults.fire(faults.EVLOOP_STALL, loop=self.name)

    # ---- read side ---------------------------------------------------------

    def culprits(self, k: int = 10) -> List[dict]:
        with self._clock:
            rows = [
                {"callback": name, "kind": row[3], "count": row[0],
                 "total_ms": round(row[1] * 1e3, 3),
                 "max_ms": round(row[2] * 1e3, 3)}
                for name, row in self._culprits.items()
            ]
        rows.sort(key=lambda r: r["total_ms"], reverse=True)
        return rows[:k]

    def snapshot(self) -> dict:
        return {
            "loop": self.name,
            "lag_ms": round(self.lag * 1e3, 3),
            "utilization": round(self.utilization, 4),
            "ticks": self.ticks,
            "slow_callbacks": self.slow_callbacks,
            "stalls": self.stalls,
            "slow_threshold_ms": round(self.slow_s * 1e3, 1),
            "stall_budget_ms": round(self.stall_budget_s * 1e3, 1),
            "culprits": self.culprits(),
        }


# ---- the cross-thread stall watchdog ---------------------------------------

class _Watchdog:
    """One daemon thread scanning every attached loop's breadcrumb.  A
    breadcrumb older than that loop's ``stall_budget_s`` is a stall:
    grab the reactor thread's live stack (``sys._current_frames`` — the
    same machinery the profiler samples with), fold it outermost-first,
    and dump a flight-recorder incident.  One dump per episode: the
    breadcrumb's start timestamp is the episode id."""

    def __init__(self, tick_s: float = WATCHDOG_TICK_S):
        self.tick_s = float(tick_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dumped: Dict[int, float] = {}  # id(telem) -> episode start

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="gk-evloop-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            join_thread(t, 2.0, "evloop watchdog")
            self._thread = None
        self._dumped.clear()

    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.scan()
            except Exception:
                # one bad scan must not kill the watchdog
                log.exception("evloop watchdog scan failed")

    def scan(self, now: Optional[float] = None) -> int:
        """One pass over the attached loops; returns stalls dumped
        (tests call this directly)."""
        now = time.perf_counter() if now is None else now
        dumped = 0
        for loop, telem in loops():
            crumb = telem.cur
            if crumb is None:
                self._dumped.pop(id(telem), None)
                continue
            fn, kind, started = crumb
            if now - started < telem.stall_budget_s:
                continue
            if self._dumped.get(id(telem)) == started:
                continue  # this episode already produced its artifact
            self._dumped[id(telem)] = started
            dumped += 1
            self._incident(loop, telem, fn, kind, started, now)
        return dumped

    def _incident(self, loop, telem, fn, kind: str, started: float,
                  now: float) -> None:
        stack = self._reactor_stack(loop)
        culprit = _culprit_name(fn)
        telem.stalls += 1
        record_evloop_stall(telem.name)
        gklog.log_event(
            log,
            f"reactor stall: {culprit} has held loop {telem.name!r} "
            f"for {(now - started) * 1e3:.0f}ms",
            event_type="evloop_stall",
            loop=telem.name, callback=culprit, kind=kind,
            held_ms=round((now - started) * 1e3, 1),
        )
        flightrec.record(
            flightrec.EVLOOP_STALL, via="watchdog",
            loop=telem.name, callback=culprit, kind=kind,
            held_ms=round((now - started) * 1e3, 1),
            stack=stack,
        )
        flightrec.dump("evloop_stall")

    @staticmethod
    def _reactor_stack(loop) -> List[str]:
        ident = getattr(loop, "thread_ident", None)
        if ident is None:
            return []
        frame = sys._current_frames().get(ident)
        stack: List[str] = []
        while frame is not None and len(stack) < MAX_DEPTH:
            stack.append(_fold_frame(frame))
            frame = frame.f_back
        stack.reverse()  # outermost first, like the profiler's folds
        return stack


# ---- module registry (loops + doors) ---------------------------------------

_LOCK = threading.Lock()
_LOOPS: List[Tuple[object, ReactorTelemetry]] = []
_DOORS: List[object] = []
_WATCHDOG = _Watchdog()


def attach(loop, name: Optional[str] = None,
           slow_s: float = SLOW_CALLBACK_S,
           stall_budget_s: float = STALL_BUDGET_S,
           heartbeat_s: float = HEARTBEAT_S) -> ReactorTelemetry:
    """Instrument ``loop``: build its sink, start the heartbeat once the
    loop runs, register with the watchdog, and wire the brownout
    composite's loop-lag provider.  Call AFTER ``loop.start()`` (the
    heartbeat posts a timer).  Idempotent per loop."""
    with _LOCK:
        for lp, telem in _LOOPS:
            if lp is loop:
                return telem
        telem = ReactorTelemetry(loop, name=name, slow_s=slow_s,
                                 stall_budget_s=stall_budget_s,
                                 heartbeat_s=heartbeat_s)
        _LOOPS.append((loop, telem))
    loop.set_telemetry(telem)
    telem.start_heartbeat()
    _WATCHDOG.start()
    # the brownout signal is the worst lag across attached loops; the
    # provider is module-level so N loops share one composite input
    try:
        from . import brownout

        brownout.get_controller().set_providers(loop_lag=max_lag)
    except Exception:
        log.debug("brownout loop-lag wiring failed", exc_info=True)
    return telem


def detach(loop) -> None:
    """Drop ``loop``'s instrumentation (flushing what remains) and stop
    the watchdog when the last loop leaves."""
    telem = None
    with _LOCK:
        for i, (lp, t) in enumerate(_LOOPS):
            if lp is loop:
                telem = t
                del _LOOPS[i]
                break
        empty = not _LOOPS
    if telem is not None:
        telem.stop_heartbeat()
        try:
            loop.set_telemetry(None)
        except Exception:
            log.debug("telemetry unhook failed on detach", exc_info=True)
        telem.flush()
    if empty:
        _WATCHDOG.stop()


def loops() -> List[Tuple[object, ReactorTelemetry]]:
    with _LOCK:
        return list(_LOOPS)


def max_lag() -> float:
    """Worst heartbeat skew across attached loops — the brownout
    composite's loop-lag provider."""
    worst = 0.0
    for _, telem in loops():
        if telem.lag > worst:
            worst = telem.lag
    return worst


def snapshot() -> dict:
    """The /fleetz reactor section: one entry per attached loop."""
    return {
        "loops": [telem.snapshot() for _, telem in loops()],
        "watchdog": {
            "running": (_WATCHDOG._thread is not None
                        and _WATCHDOG._thread.is_alive()),
            "tick_s": _WATCHDOG.tick_s,
        },
    }


# ---- connection introspection (the /debug/connz registry) ------------------

def register_door(door) -> None:
    """Register a serving edge exposing ``connz() -> list[dict]`` (the
    event door, the replica wire listener) for /debug/connz."""
    with _LOCK:
        if door not in _DOORS:
            _DOORS.append(door)


def unregister_door(door) -> None:
    with _LOCK:
        try:
            _DOORS.remove(door)
        except ValueError:
            pass


def connz_snapshot(limit: Optional[int] = None) -> dict:
    """All registered edges' per-connection rows, worst write-backlog
    first (the conn most likely drowning the loop sorts to the top),
    bounded by ``limit``."""
    with _LOCK:
        doors = list(_DOORS)
    conns: List[dict] = []
    for door in doors:
        try:
            conns.extend(door.connz())
        except Exception:
            # one edge's defect must not blind the whole endpoint
            log.debug("connz snapshot failed for %r", door,
                      exc_info=True)
    total = len(conns)
    conns.sort(key=lambda c: c.get("write_backlog", 0), reverse=True)
    if limit is not None and limit >= 0:
        conns = conns[:limit]
    return {"total": total, "shown": len(conns), "connections": conns}


def get_watchdog() -> _Watchdog:
    return _WATCHDOG


def reset() -> None:
    """Tests: drop every attached loop and door, stop the watchdog."""
    with _LOCK:
        loops_, _LOOPS[:] = list(_LOOPS), []
        _DOORS[:] = []
    for lp, telem in loops_:
        telem.stop_heartbeat()
        try:
            lp.set_telemetry(None)
        except Exception:
            log.debug("telemetry unhook failed on reset", exc_info=True)
    _WATCHDOG.stop()
