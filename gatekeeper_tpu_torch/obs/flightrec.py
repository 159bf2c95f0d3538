"""Black-box flight recorder: a bounded, replica-tagged ring
of significant cross-subsystem events, dumped atomically to disk when an
incident fires — so a CHAOS_r08-style post-mortem starts from ONE ordered
artifact instead of N interleaved log tails.

Event sources (each site records through one guarded call):

  breaker_transition   ops/driver.py _on_breaker_transition (state edges;
                       an open edge also triggers an automatic dump)
  brownout_step        obs/brownout.py ladder transitions
  mesh_degrade         ops/driver.py degrade_mesh (width w -> w//2)
  slo_alert            obs/slo.py burn-alert activation/clear edges (an
                       activation also triggers an automatic dump)
  shed_burst           metrics/catalog.py record_shed, COALESCED: per-
                       reason 1s windows, so an overload storm lands as
                       a handful of burst events, never 10k ring entries
  snapshot_restore     metrics/catalog.py record_snapshot_outcome
  route_flip           obs/routeledger.py (the evaluation router changed
                       tier, including breaker/compile-pending overrides)
  evloop_stall         obs/reactorobs.py — a reactor callback ran past the
                       slow-callback threshold (attribution names the
                       culprit), or the cross-thread watchdog caught the
                       loop stalled past budget (the event then carries
                       the reactor thread's folded stack and also
                       triggers an automatic dump)

Every event carries a process-monotonic ``seq`` (total order within the
process), a monotonic timestamp for interval math, a wall timestamp for
rendering, the replica id, the event type and its attributes.  The ring
is bounded (default 512 events); recording is a lock + deque append.

Dumps: ``dump(reason)`` writes the ring (pending shed windows flushed)
as one JSON artifact via write-temp-rename, with bounded retention.
Triggers: breaker-open, SLO alert activation, process death (the
``install_exit_hook`` atexit + chained-SIGTERM hook), and on demand via
``/debug/flightrecz?dump=1`` (obs/debug.py).  Without a configured
directory every trigger is a no-op — the in-memory ring still serves the
debug endpoint.

The recorder must never fail the subsystem reporting the incident: every
public entry point swallows defects through the counted-drop contract
(metrics.catalog.record_dropped).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .. import logging as gklog

log = gklog.get("obs.flightrec")

# ---- stable event types (docs/observability.md documents each) --------------

BREAKER_TRANSITION = "breaker_transition"
BROWNOUT_STEP = "brownout_step"
MESH_DEGRADE = "mesh_degrade"
SLO_ALERT = "slo_alert"
SHED_BURST = "shed_burst"
SNAPSHOT_RESTORE = "snapshot_restore"
ROUTE_FLIP = "route_flip"
EVLOOP_STALL = "evloop_stall"

#: every event type a record() site may emit — tools/check_observability.py
#: asserts each is documented in docs/observability.md
EVENT_TYPES = (
    BREAKER_TRANSITION,
    BROWNOUT_STEP,
    MESH_DEGRADE,
    SLO_ALERT,
    SHED_BURST,
    SNAPSHOT_RESTORE,
    ROUTE_FLIP,
    EVLOOP_STALL,
)

#: shed recordings inside one window coalesce into one shed_burst event
SHED_WINDOW_S = 1.0

_DEFAULT_RING = 512
_DEFAULT_RETAIN = 8


def _dropped(site: str):
    from ..metrics.catalog import record_dropped

    record_dropped(site)


class FlightRecorder:
    """One process's event ring + dump machinery."""

    def __init__(self, maxlen: int = _DEFAULT_RING):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(maxlen), 16))
        self._seq = itertools.count(1)
        self._dir: Optional[str] = None
        self._retain = _DEFAULT_RETAIN
        self._dump_seq = itertools.count(1)
        self._exit_hook_installed = False
        # pending per-reason shed windows: reason -> [count, window_start]
        self._sheds: Dict[str, list] = {}
        self.dumps = 0  # completed dump files (tests/bench)
        self.last_dump_path: Optional[str] = None

    # ---- configuration -----------------------------------------------------

    def configure(self, dump_dir: Optional[str] = None,
                  maxlen: Optional[int] = None,
                  retain: Optional[int] = None):
        with self._lock:
            if dump_dir is not None:
                self._dir = dump_dir or None
            if maxlen is not None:
                self._ring = deque(self._ring, maxlen=max(int(maxlen), 16))
            if retain is not None:
                self._retain = max(int(retain), 1)
        return self

    # ---- recording ---------------------------------------------------------

    def record(self, event_type: str, **attrs):
        """Append one event.  Guarded: a recorder defect must never fail
        the subsystem reporting the incident.  Pending shed windows are
        flushed FIRST so sheds that preceded (and typically caused) this
        event sequence before it — the artifact must never show the page
        before the overload that triggered it."""
        try:
            self._flush_sheds()
            self._append(event_type, attrs)
        except Exception:  # telemetry never blocks the reporting path
            _dropped("flightrec.record")

    def _append(self, event_type: str, attrs: dict):
        from ..util import replica_id

        ev = {
            # ordering and interval math use the monotonic field; wall
            # time is for rendering only
            "t": round(time.time(), 6),  # wall-clock: ok (event stamp)
            "mono": round(time.perf_counter(), 6),
            "type": event_type,
            "replica_id": replica_id(),
        }
        if attrs:
            ev.update(attrs)
        with self._lock:
            # seq assigned UNDER the lock: drawing it outside would let
            # two racing records land in the ring out of seq order,
            # breaking the total-order contract events() relies on
            ev["seq"] = next(self._seq)
            self._ring.append(ev)

    def note_shed(self, reason: str, n: int = 1):
        """Coalesce shed recordings into per-reason SHED_WINDOW_S bursts:
        an overload storm must land as a handful of events, not evict the
        whole ring.  Guarded like record()."""
        if n <= 0:
            return
        try:
            now = time.perf_counter()
            flush = None
            with self._lock:
                pending = self._sheds.get(reason)
                if pending is not None and now - pending[1] > SHED_WINDOW_S:
                    flush = (reason, pending[0], pending[1])
                    pending = None
                if pending is None:
                    self._sheds[reason] = [n, now]
                else:
                    pending[0] += n
            if flush is not None:
                self._emit_shed(*flush)
        except Exception:  # telemetry never blocks the shed path
            _dropped("flightrec.note_shed")

    def _emit_shed(self, reason: str, count: int, window_start: float):
        # window_start_mono makes the true onset recoverable even though
        # the burst's seq is assigned at flush time
        self._append(SHED_BURST, {
            "reason": reason,
            "count": count,
            "window_s": round(time.perf_counter() - window_start, 3),
            "window_start_mono": round(window_start, 6),
        })

    def _flush_sheds(self):
        """Emit every pending shed window (snapshot/dump time)."""
        with self._lock:
            pending = list(self._sheds.items())
            self._sheds.clear()
        for reason, (count, start) in pending:
            self._emit_shed(reason, count, start)

    # ---- retrieval ---------------------------------------------------------

    def events(self, limit: Optional[int] = None) -> List[dict]:
        """Ring snapshot in causal (seq) order, oldest first; ``limit``
        keeps the NEWEST N."""
        self._flush_sheds()
        with self._lock:
            out = list(self._ring)
        if limit is not None and limit >= 0:
            # limit=0 means none — a bare [-0:] would return everything
            out = out[-limit:] if limit else []
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._sheds.clear()

    # ---- dumping -----------------------------------------------------------

    def dump(self, reason: str) -> Optional[str]:
        """Write the ring as one JSON artifact (write-temp-rename, bounded
        retention).  Returns the path, or None when no directory is
        configured or the write failed.  Guarded — dump triggers ride
        incident paths (breaker trip, SIGTERM)."""
        try:
            return self._dump(reason)
        except Exception:
            _dropped("flightrec.dump")
            return None

    def _dump(self, reason: str) -> Optional[str]:
        with self._lock:
            directory = self._dir
        if not directory:
            return None
        events = self.events()
        from ..util import replica_id

        payload = {
            "reason": reason,
            "replica_id": replica_id(),
            "dumped_at": round(time.time(), 6),  # wall-clock: ok (header)
            "event_count": len(events),
            "events": events,
        }
        os.makedirs(directory, exist_ok=True)
        rid = replica_id() or "solo"
        name = (
            f"flightrec-{rid}-{reason}-"
            f"{os.getpid()}-{next(self._dump_seq):04d}.json"
        )
        path = os.path.join(directory, name)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)  # atomic: a reader never sees a torn dump
        with self._lock:
            self.dumps += 1
            self.last_dump_path = path
        self._prune(directory)
        gklog.log_event(
            log, f"flight recorder dumped {len(events)} events ({reason})",
            event_type="flightrec_dump", reason=reason, path=path,
            events=len(events),
        )
        return path

    def _prune(self, directory: str):
        """Keep the newest ``retain`` dump files in ``directory``."""
        try:
            names = sorted(
                n for n in os.listdir(directory)
                if n.startswith("flightrec-") and n.endswith(".json")
            )
            with self._lock:
                retain = self._retain
            for name in names[:-retain] if len(names) > retain else []:
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    log.debug("flightrec prune failed for %s", name,
                              exc_info=True)
        except OSError:
            log.debug("flightrec retention pass failed", exc_info=True)

    # ---- process-death trigger ---------------------------------------------

    def install_exit_hook(self):
        """Dump on process death: atexit always; SIGTERM by CHAINING the
        previous handler (the fleet replica runtime installs its own
        process-group cleanup — both must run).  Idempotent; a no-op
        outside the main thread (signal registration would raise)."""
        with self._lock:
            if self._exit_hook_installed:
                return self
            self._exit_hook_installed = True
        import atexit

        atexit.register(self._exit_dump, "process_exit")
        try:
            import signal

            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                self._exit_dump("sigterm")
                if prev == signal.SIG_IGN:
                    return  # the process chose to ignore SIGTERM: honor it
                if callable(prev):
                    prev(signum, frame)
                else:
                    # default disposition: re-raise so the process still
                    # dies with the conventional 143
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError, RuntimeError):
            # not the main thread (tests, embedders): atexit still covers
            # orderly death; a SIGTERM then skips the dump, by design
            log.debug("flightrec SIGTERM hook unavailable", exc_info=True)
        return self

    def _exit_dump(self, reason: str):
        """Best-effort terminal dump: only when events exist (an idle
        process must not litter dump dirs on every clean exit)."""
        try:
            if self._dir and (self._ring or self._sheds):
                self._dump(reason)
        # interpreter teardown: even the drop counter may be gone
        # gklint: disable=swallowed-exception -- last-ditch guard on the
        # interpreter-exit path; nothing downstream can observe it
        except Exception:
            pass


# defensive env parse (the $GK_PROFILER_HZ lesson): a typo'd size must
# warn and fall back, never make this module unimportable — the import
# happens lazily from INCIDENT paths (breaker trip, mesh degrade)
try:
    _ring_size = int(os.environ.get("GK_FLIGHTREC_SIZE",
                                    str(_DEFAULT_RING)))
except ValueError:
    log.warning("GK_FLIGHTREC_SIZE=%r is not an integer; using %d",
                os.environ.get("GK_FLIGHTREC_SIZE"), _DEFAULT_RING)
    _ring_size = _DEFAULT_RING
_RECORDER = FlightRecorder(maxlen=_ring_size)
if os.environ.get("GK_FLIGHTREC_DIR"):
    _RECORDER.configure(dump_dir=os.environ["GK_FLIGHTREC_DIR"])


def get_recorder() -> FlightRecorder:
    return _RECORDER


def record(event_type: str, **attrs):
    """Module-level feed so event sites need no recorder handle."""
    _RECORDER.record(event_type, **attrs)


def note_shed(reason: str, n: int = 1):
    _RECORDER.note_shed(reason, n)


def dump(reason: str) -> Optional[str]:
    return _RECORDER.dump(reason)
