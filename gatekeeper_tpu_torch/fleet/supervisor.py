"""Replica supervision: detect, restart, quarantine, drain.

A :class:`ReplicaSupervisor` owns N webhook replicas (the
fleet/replica.py subprocess runtime) and keeps the fleet serving through
individual replica failures:

- **detection** — a monitor thread watches each replica for *exit*
  (``proc.poll()``), for *HTTP wedge* (consecutive ``/healthz`` probe
  failures: the ready-probe heartbeat) and for *pipe wedge* (consecutive
  unanswered ``{"cmd": "ping"}`` commands: command-pipe liveness — a
  child whose command loop stopped draining stdin is one honest wedge
  signature, and the seeded ``fleet.replica_wedge`` fault produces
  exactly it);
- **restart** — a failed replica is killed (whole process group) and
  respawned from the same shared sealed snapshot + AOT cache, so the
  replacement is warm in seconds; restart attempts
  pace on a capped exponential backoff (:class:`syncutil.Backoff`);
- **flap quarantine** — a replica that crashes ``flap_threshold`` times
  within ``flap_window_s`` is quarantined: no further restarts, state
  exported as ``fleet_replica_state{replica_id}`` = 2 — a crash-looping
  replica (poisoned cache entry, bad node) must not burn the fleet's
  spawn capacity forever.  ``revive()`` re-arms it;
- **front-door integration** — ``on_backend_change(replica_id, backend
  | None)`` fires on every liveness transition; wiring it to
  ``FrontDoor.suspend`` / ``FrontDoor.set_backend`` keeps traffic off
  dead replicas and re-points the door at the restarted port;
- **graceful drain + rolling restart** — ``drain()`` runs the child's
  drain protocol (stop accepting, flush the micro-batcher within a
  deadline budget); ``rolling_restart()`` sequences eject -> drain ->
  stop -> respawn -> readmit per replica, so a fleet upgrades with zero
  failed admissions;
- **zombie hygiene** — replicas are spawned in their own process groups
  and the supervisor registers one process-wide SIGTERM + atexit hook
  killing every live group, so neither an orderly parent death nor a
  SIGTERM leaves orphaned replica trees (children of a SIGKILLed parent
  still exit on their stdin EOF — the pipe is the lifetime).

Everything is driven through the same spawn helpers bench.py and the
tier-1 tools use; `tools/check_self_heal.py` proves the kill -> warm
restart -> parity loop on every test run.
"""

from __future__ import annotations

import atexit
import http.client
import os
import signal
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from .. import logging as gklog
from ..metrics.catalog import record_replica_restart, record_replica_state
from ..syncutil import Backoff
from .replica import ReplicaHandle, spawn_replica
from ..util import join_thread

log = gklog.get("fleet.supervisor")

# fleet_replica_state gauge codes
RUNNING, RESTARTING, QUARANTINED, DRAINING, STOPPED = range(5)
_STATE_NAMES = {
    RUNNING: "running", RESTARTING: "restarting",
    QUARANTINED: "quarantined", DRAINING: "draining", STOPPED: "stopped",
}


# ---- process-wide zombie cleanup -------------------------------------------
# One registry of live supervised process groups; one atexit hook and one
# chained SIGTERM handler kill them all.  Module-level (not per
# supervisor) so multiple supervisors in one process share the single
# signal slot.

_live_pgids: set = set()
_cleanup_lock = threading.Lock()
_cleanup_installed = False
_prev_sigterm = None


def _kill_registered_groups():
    with _cleanup_lock:
        pgids = list(_live_pgids)
        _live_pgids.clear()
    for pgid in pgids:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass


def _sigterm_handler(signum, frame):
    _kill_registered_groups()
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    else:
        # restore + re-raise so the default disposition (terminate)
        # still applies after cleanup
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def install_cleanup():
    """Idempotently register the atexit + SIGTERM process-group sweeper.
    Called by every ReplicaSupervisor; safe (and a no-op for the signal
    part) off the main thread."""
    global _cleanup_installed, _prev_sigterm
    with _cleanup_lock:
        if _cleanup_installed:
            return
        _cleanup_installed = True
    atexit.register(_kill_registered_groups)
    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _sigterm_handler)
    except ValueError:
        # not the main thread: atexit still covers orderly exits
        log.debug("SIGTERM cleanup not installed (not on the main thread)")


def _register_group(pid: int):
    with _cleanup_lock:
        _live_pgids.add(pid)


def _unregister_group(pid: int):
    with _cleanup_lock:
        _live_pgids.discard(pid)


# ---- the supervisor --------------------------------------------------------


class _Slot:
    """Supervision state for one replica identity (the identity outlives
    any single process incarnation)."""

    def __init__(self, replica_id: str, backoff: Backoff):
        self.replica_id = replica_id
        self.handle: Optional[ReplicaHandle] = None
        self.state = STOPPED
        self.backoff = backoff
        self.restart_at = 0.0          # monotonic; 0 = not scheduled
        self.started_at = 0.0          # last successful (re)start
        self.crash_times: deque = deque()
        self.restarts = 0
        self.http_miss = 0
        self.ping_miss = 0
        self.last_exit_rc: Optional[int] = None
        self.last_restart_s: Optional[float] = None
        self.quarantined_reason = ""
        # why the pending/last restart happened (crash/wedge/rolling):
        # recorded into fleet_replica_restarts_total only when the
        # respawn SUCCEEDS — the metric counts restarts, not failures
        self.restart_reason = ""


class ReplicaSupervisor:
    """Spawn-or-adopt N replicas and keep them alive (module docstring).

    on_backend_change(replica_id, backend_dict_or_None) is invoked
    OUTSIDE supervisor locks: None = stop routing to this replica,
    a dict = (re)start routing to {"host", "port", "replica_id"}.
    """

    def __init__(
        self,
        snapshot_dir: str = "",
        cache_dir: str = "",
        extra_flags: Sequence[str] = (),
        env: Optional[Dict[str, str]] = None,
        heartbeat_s: float = 0.25,
        probe_timeout_s: float = 2.0,
        miss_threshold: int = 3,
        spawn_timeout_s: float = 300.0,
        backoff_base_s: float = 0.25,
        backoff_cap_s: float = 10.0,
        flap_window_s: float = 30.0,
        flap_threshold: int = 5,
        on_backend_change: Optional[Callable] = None,
    ):
        self.snapshot_dir = snapshot_dir
        self.cache_dir = cache_dir
        self.extra_flags = list(extra_flags)
        self.env = dict(env) if env else None
        self.heartbeat_s = heartbeat_s
        self.probe_timeout_s = probe_timeout_s
        self.miss_threshold = max(1, int(miss_threshold))
        self.spawn_timeout_s = spawn_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.flap_window_s = flap_window_s
        self.flap_threshold = max(2, int(flap_threshold))
        self.on_backend_change = on_backend_change
        self._slots: Dict[str, _Slot] = {}
        self._mu = threading.RLock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        install_cleanup()

    # ---- construction -----------------------------------------------------

    def _new_slot(self, replica_id: str) -> _Slot:
        return _Slot(replica_id, Backoff(
            base=self.backoff_base_s, factor=2.0, cap=self.backoff_cap_s,
            jitter=0.25,
        ))

    def _set_state(self, slot: _Slot, state: int):
        slot.state = state
        record_replica_state(slot.replica_id, state)

    def adopt(self, handle: ReplicaHandle):
        """Supervise an already-spawned replica."""
        with self._mu:
            slot = self._slots.get(handle.replica_id)
            if slot is None:
                slot = self._slots[handle.replica_id] = self._new_slot(
                    handle.replica_id
                )
            slot.handle = handle
            slot.started_at = time.monotonic()
            slot.http_miss = slot.ping_miss = 0
            self._set_state(slot, RUNNING)
        _register_group(handle.proc.pid)

    def start(self, n: int) -> List[ReplicaHandle]:
        """Spawn r0..r{n-1} sequentially (spawn_fleet's contention rationale)
        under supervision, then start the monitor.  Raises on a failed
        initial spawn after stopping whatever came up."""
        handles: List[ReplicaHandle] = []
        try:
            for i in range(n):
                handles.append(self._spawn(f"r{i}"))
        except BaseException:
            self.stop()
            raise
        self.start_monitor()
        return handles

    def start_monitor(self):
        if self._monitor is not None and self._monitor.is_alive():
            return
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._loop, name="replica-supervisor", daemon=True
        )
        self._monitor.start()

    def _spawn(self, replica_id: str) -> ReplicaHandle:
        handle = spawn_replica(
            replica_id, self.snapshot_dir, self.cache_dir,
            extra_flags=self.extra_flags, env=self.env,
            timeout_s=self.spawn_timeout_s,
        )
        self.adopt(handle)
        self._notify(replica_id, handle.backend())
        return handle

    def _notify(self, replica_id: str, backend: Optional[dict]):
        cb = self.on_backend_change
        if cb is None:
            return
        try:
            cb(replica_id, backend)
        except Exception:
            log.exception("on_backend_change(%s) failed", replica_id)

    # ---- detection --------------------------------------------------------

    def _probe_http(self, handle: ReplicaHandle) -> bool:
        try:
            conn = http.client.HTTPConnection(
                handle.host, handle.port, timeout=self.probe_timeout_s
            )
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            resp.read()
            conn.close()
            return resp.status == 200
        except Exception:
            return False

    def _probe_pipe(self, handle: ReplicaHandle) -> bool:
        try:
            reply = handle.command(
                {"cmd": "ping"}, timeout_s=self.probe_timeout_s
            )
            return reply.get("event") == "pong"
        except Exception:
            return False

    def _loop(self):
        while not self._stop.wait(self.heartbeat_s):
            with self._mu:
                slots = list(self._slots.values())
            for slot in slots:
                if self._stop.is_set():
                    return
                try:
                    self._check(slot)
                except Exception:
                    log.exception("supervisor check failed for %s",
                                  slot.replica_id)

    def _check(self, slot: _Slot):
        if slot.state == QUARANTINED:
            return
        if slot.state == RESTARTING:
            if time.monotonic() >= slot.restart_at:
                self._restart(slot)
            return
        handle = slot.handle
        if handle is None or slot.state in (DRAINING, STOPPED):
            return
        rc = handle.proc.poll()
        if rc is not None:
            slot.last_exit_rc = rc
            self._on_failure(slot, "crash", f"exited rc={rc}")
            return
        # ready-probe heartbeat (HTTP) — a dead listener or a wedged
        # serving path misses; one success clears the streak
        if self._probe_http(handle):
            slot.http_miss = 0
        else:
            slot.http_miss += 1
        # command-pipe liveness — skipped while a caller's long command
        # (a bench stream) legitimately occupies the single-threaded
        # command loop
        if handle.inflight_commands == 0:
            if self._probe_pipe(handle):
                slot.ping_miss = 0
            else:
                slot.ping_miss += 1
        if slot.http_miss >= self.miss_threshold:
            self._on_failure(
                slot, "wedge", f"{slot.http_miss} missed health probes"
            )
        elif slot.ping_miss >= self.miss_threshold:
            self._on_failure(
                slot, "wedge", f"{slot.ping_miss} unanswered pipe pings"
            )

    # ---- restart / quarantine ---------------------------------------------

    def _on_failure(self, slot: _Slot, reason: str, detail: str):
        now = time.monotonic()
        uptime = now - slot.started_at if slot.started_at else 0.0
        log.warning("replica %s failed (%s: %s; up %.1fs)",
                    slot.replica_id, reason, detail, uptime)
        # keep the ORIGINAL failure reason across failed respawn attempts
        # (a restart-spawn failure re-enters here with reason="crash")
        if not slot.restart_reason:
            slot.restart_reason = reason
        self._notify(slot.replica_id, None)  # stop routing first
        if slot.handle is not None:
            _unregister_group(slot.handle.proc.pid)
            slot.handle.kill()  # wedged children need the hard kill
            slot.handle = None
        slot.http_miss = slot.ping_miss = 0
        # flap detection over a sliding window
        slot.crash_times.append(now)
        while slot.crash_times and \
                now - slot.crash_times[0] > self.flap_window_s:
            slot.crash_times.popleft()
        if len(slot.crash_times) >= self.flap_threshold:
            slot.quarantined_reason = (
                f"{len(slot.crash_times)} failures in "
                f"{self.flap_window_s:.0f}s (last: {reason}: {detail})"
            )
            log.error("replica %s QUARANTINED: %s — no further restarts "
                      "until revive()", slot.replica_id,
                      slot.quarantined_reason)
            self._set_state(slot, QUARANTINED)
            return
        # a long stable run earns a fresh backoff ladder
        if uptime > 2 * self.backoff_cap_s:
            slot.backoff.reset()
        delay = slot.backoff.next()
        slot.restart_at = now + delay
        self._set_state(slot, RESTARTING)
        log.info("replica %s restart scheduled in %.2fs",
                 slot.replica_id, delay)

    def _restart(self, slot: _Slot):
        t0 = time.monotonic()
        try:
            handle = spawn_replica(
                slot.replica_id, self.snapshot_dir, self.cache_dir,
                extra_flags=self.extra_flags, env=self.env,
                timeout_s=self.spawn_timeout_s,
            )
        except Exception as e:
            log.warning("replica %s restart failed (%s: %s)",
                        slot.replica_id, type(e).__name__, e)
            self._on_failure(slot, "crash", "restart spawn failed")
            return
        slot.restarts += 1
        slot.last_restart_s = round(time.monotonic() - t0, 3)
        record_replica_restart(
            slot.replica_id, slot.restart_reason or "crash"
        )
        slot.restart_reason = ""
        self.adopt(handle)
        self._notify(slot.replica_id, handle.backend())
        log.info("replica %s restarted warm in %.2fs (ready_s=%.2fs, "
                 "restore=%s)", slot.replica_id, slot.last_restart_s,
                 handle.ready_s, handle.ready.get("restore_outcome"))

    def revive(self, replica_id: str):
        """Re-arm a quarantined replica: fresh backoff, immediate restart
        eligibility."""
        with self._mu:
            slot = self._slots.get(replica_id)
            if slot is None or slot.state != QUARANTINED:
                return
            slot.crash_times.clear()
            slot.backoff.reset()
            slot.restart_at = time.monotonic()
            slot.quarantined_reason = ""
            self._set_state(slot, RESTARTING)

    # ---- graceful drain / rolling restart ----------------------------------

    def drain(self, replica_id: str, deadline_ms: float = 1000.0) -> dict:
        """Run the child's drain protocol: the replica stops accepting
        (server 503s new admissions), flushes its micro-batcher within
        the deadline budget, and reports.  The caller (or
        rolling_restart) must have ejected it from the front door first
        — drain stops INTAKE, the door stops ROUTING."""
        with self._mu:
            slot = self._slots.get(replica_id)
            handle = slot.handle if slot else None
        if handle is None:
            raise KeyError(f"no live replica {replica_id!r}")
        self._set_state(slot, DRAINING)
        try:
            return handle.command(
                {"cmd": "drain", "deadline_ms": deadline_ms},
                # the child bounds the flush by deadline_ms; the pipe
                # wait only needs framing slack on top
                timeout_s=deadline_ms / 1e3 + self.probe_timeout_s,
            )
        finally:
            if slot.state == DRAINING:
                self._set_state(slot, RUNNING)

    def rolling_restart(self, drain_deadline_ms: float = 1000.0) -> dict:
        """Zero-failed-admission rolling restart: per replica, eject from
        the front door, drain (flush in-flight work within budget), stop,
        respawn from the shared warmth, readmit — then the next one.
        Returns per-replica drain stats + restart seconds."""
        out: Dict[str, dict] = {}
        with self._mu:
            ids = sorted(self._slots)
        for rid in ids:
            with self._mu:
                slot = self._slots.get(rid)
                handle = slot.handle if slot else None
            if handle is None:
                continue  # dead/quarantined: nothing to roll
            self._set_state(slot, DRAINING)
            self._notify(rid, None)           # door stops routing
            try:
                drained = self.drain(rid, deadline_ms=drain_deadline_ms)
            except Exception as e:
                drained = {"error": f"{type(e).__name__}: {e}"}
            self._set_state(slot, DRAINING)   # drain() reset it to RUNNING
            _unregister_group(handle.proc.pid)
            handle.stop()
            slot.handle = None
            t0 = time.monotonic()
            # park restart_at in the far future BEFORE flipping the state:
            # the monitor must not race this thread into a double spawn
            slot.restart_at = t0 + 1e9
            slot.restart_reason = "rolling"
            self._set_state(slot, RESTARTING)
            self._restart(slot)               # respawns + notifies
            out[rid] = {
                "drain": drained,
                "restart_s": round(time.monotonic() - t0, 3),
                "ok": slot.state == RUNNING,
            }
        return out

    # ---- introspection / shutdown ------------------------------------------

    def handles(self) -> List[ReplicaHandle]:
        with self._mu:
            return [s.handle for s in self._slots.values()
                    if s.handle is not None]

    # live target rosters for the fleet observability plane
    # (obs/fleetobs.py): passed as the collectors' targets() callables so
    # federation/assembly follow restarts onto fresh ephemeral ports

    def trace_targets(self) -> List[dict]:
        """{replica_id, host, port} per live replica — its webhook
        listener, where /debug/traces is served."""
        return [
            {"replica_id": h.replica_id, "host": h.host, "port": h.port}
            for h in self.handles()
        ]

    def metrics_targets(self) -> List[dict]:
        """{replica_id, host, port} per live replica — its metrics
        exporter, for the federator's scrape."""
        return [
            {"replica_id": h.replica_id, "host": h.host,
             "port": h.metrics_port}
            for h in self.handles() if h.metrics_port
        ]

    def status(self) -> dict:
        with self._mu:
            return {
                rid: {
                    "state": _STATE_NAMES[s.state],
                    "restarts": s.restarts,
                    "last_restart_s": s.last_restart_s,
                    "last_exit_rc": s.last_exit_rc,
                    "pid": s.handle.proc.pid if s.handle else None,
                    "port": s.handle.port if s.handle else None,
                    "quarantined_reason": s.quarantined_reason or None,
                }
                for rid, s in sorted(self._slots.items())
            }

    def stop(self):
        """Stop the monitor and every live replica (orderly: stdin close,
        escalating to the process-group kill)."""
        self._stop.set()
        if self._monitor is not None:
            join_thread(self._monitor, 10.0, "replica supervisor monitor")
            self._monitor = None
        with self._mu:
            slots = list(self._slots.values())
        for slot in slots:
            handle = slot.handle
            slot.handle = None
            self._set_state(slot, STOPPED)
            if handle is not None:
                _unregister_group(handle.proc.pid)
                handle.stop()
