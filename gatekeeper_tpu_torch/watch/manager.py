"""Dynamic watch management (reference pkg/watch/manager.go, registrar.go,
replay.go, controller_switch.go).

Capabilities mirrored:
- named Registrars declare a desired GVK set (add/remove/replace), events fan
  out to each registrar's queue (manager.go:280-373)
- the first registrar for a GVK starts the underlying watch ("informer"),
  the last one leaving stops it (manager.go:174-239)
- late joiners get an async REPLAY of currently-listed objects as ADDED
  events (replay.go:35-120)
- ControllerSwitch: global teardown gate checked at the top of every
  reconcile (controller_switch.go:22-44)

TPU-first note: this layer is pure control plane — it feeds reconcilers that
mutate the Driver's compiled programs / inventory tensors; nothing here
touches the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional, Set, Tuple

from .. import faults
from ..kube.inmem import InMemoryKube, WatchEvent
from .set import GVKSet

GVK = Tuple[str, str, str]


class ControllerSwitch:
    """Global on/off gate (controller_switch.go)."""

    def __init__(self):
        self._running = True
        self._lock = threading.RLock()

    def stop(self):
        with self._lock:
            self._running = False

    def enter(self) -> bool:
        with self._lock:
            return self._running


class WatchError(Exception):
    pass


class Registrar:
    """A named consumer with a desired GVK set (registrar.go:50-75).
    Events for watched GVKs arrive on `self.events` as (gvk, WatchEvent)."""

    def __init__(self, name: str, manager: "WatchManager"):
        self.name = name
        self.manager = manager
        # gklint: disable=unbounded-queue -- by-design unbounded: the event
        # pump is bounded by cluster churn and a dropped event silently
        # desyncs the replicated cache (the RV dedup cannot repair a gap)
        self.events: "queue.Queue[Tuple[GVK, WatchEvent]]" = queue.Queue()

    def add_watch(self, gvk: GVK):
        self.manager._add_watch(self, gvk)

    def remove_watch(self, gvk: GVK):
        self.manager._remove_watch(self, gvk)

    def replace_watch(self, gvks) -> None:
        """Ensure all and only `gvks` are watched by this registrar
        (manager.go:242-277)."""
        self.manager._replace_watch(self, set(gvks))

    def watched(self) -> GVKSet:
        return self.manager.watched_by(self)


def _obj_key(obj: dict) -> Tuple[str, str]:
    meta = obj.get("metadata") or {}
    return (meta.get("namespace", "") or "", meta.get("name", "") or "")


class _Replay(threading.Thread):
    """Async late-joiner replay for one (registrar, gvk)
    (reference pkg/watch/replay.go:35-120): the snapshot list runs OFF the
    manager lock — with an HTTP-backed kube a large list takes seconds, and
    running it under the lock would stall all live fan-out for every GVK —
    with retry/backoff on list errors and cancellation on watch removal.

    Ordering contract (no stale resurrection): while the replay is in
    flight, live events for this (registrar, gvk) are BUFFERED here instead
    of delivered.  The final splice (under the manager lock, atomic w.r.t.
    fan-out) enqueues the replayed ADDEDs — skipping any object key that
    has a buffered live event, which carries strictly newer state — and
    then the buffered events in arrival order.  An object deleted after the
    snapshot therefore always surfaces its DELETED after (or instead of)
    its replayed ADDED."""

    MAX_BACKOFF = 2.0
    # list retries before giving up on the snapshot: the buffered live
    # events are then delivered (and the failure logged) so a persistently
    # unlistable GVK neither starves the registrar nor wedges drain()
    MAX_ATTEMPTS = 8

    def __init__(self, manager: "WatchManager", registrar: "Registrar",
                 gvk: GVK):
        super().__init__(daemon=True, name=f"watch-replay-{registrar.name}-{gvk}")
        self.manager = manager
        self.registrar = registrar
        self.gvk = gvk
        self.cancelled = threading.Event()
        self.pending: list = []  # live events buffered during replay

    def cancel(self):
        self.cancelled.set()

    def run(self):
        import logging

        backoff = 0.05
        objs = None
        for _attempt in range(self.MAX_ATTEMPTS):
            if self.cancelled.is_set():
                break
            try:
                objs = self.manager.kube.list(self.gvk)
                break
            except Exception:
                self.cancelled.wait(backoff)
                backoff = min(backoff * 2, self.MAX_BACKOFF)
        else:
            logging.getLogger("gatekeeper_tpu_torch.watch").warning(
                "replay list for %s/%s failed %d times; delivering live "
                "events without the snapshot",
                self.registrar.name, self.gvk, self.MAX_ATTEMPTS,
            )
        with self.manager._lock:
            # de-register the gate first — but only if it is still OURS: a
            # remove+re-add churn may have cancelled this replay and
            # installed a newer one under the same key, whose gate must
            # survive (its ordering contract depends on it)
            key = (self.registrar.name, self.gvk)
            if self.manager._replays.get(key) is self:
                del self.manager._replays[key]
            if self.cancelled.is_set():
                return  # watch removed mid-replay: drop snapshot + buffer
            fresher = {
                _obj_key(ev.object) for ev in self.pending if ev.object
            }
            for obj in objs or ():
                if _obj_key(obj) not in fresher:
                    self.registrar.events.put(
                        (self.gvk, WatchEvent("ADDED", obj))
                    )
            for ev in self.pending:
                self.registrar.events.put((self.gvk, ev))


class _Pump(threading.Thread):
    """Per-GVK event pump: reads the kube watcher, fans out to registrars.
    The single shared watch per GVK is the manager's 'informer'."""

    def __init__(self, manager: "WatchManager", gvk: GVK):
        super().__init__(daemon=True, name=f"watch-pump-{gvk}")
        self.manager = manager
        self.gvk = gvk
        # replay=False: replay to late joiners is handled per-registrar
        self.watcher = manager.kube.watch(gvk, replay=False)

    def run(self):
        while True:
            ev = self.watcher.next(timeout=0.2)
            if self.watcher._stopped:
                return
            if ev is None:
                continue
            if faults.ENABLED:
                try:
                    faults.fire(faults.WATCH_DELIVER, gvk=self.gvk)
                # gklint: disable=swallowed-exception -- the injected error
                # IS the simulated failure: dropping exactly this delivery
                # is the chaos contract (docs/failure-modes.md)
                except Exception:
                    continue  # injected delivery drop; the pump survives
            self.manager._fan_out(self.gvk, ev)

    def stop(self):
        self.watcher.stop()


class WatchManager:
    """manager.go: runtime-mutable watches over the in-memory API."""

    def __init__(self, kube: InMemoryKube, metrics_hook: Optional[Callable] = None):
        self.kube = kube
        self._lock = threading.RLock()
        self._registrars: Dict[str, Registrar] = {}
        # intent: registrar -> set of GVKs (recordKeeper, registrar.go:51-58)
        self._intent: Dict[Registrar, Set[GVK]] = {}
        self._pumps: Dict[GVK, _Pump] = {}
        # in-flight late-joiner replays, keyed (registrar name, gvk); live
        # events for these route into the replay's buffer (ordering
        # contract in _Replay)
        self._replays: Dict[Tuple[str, GVK], _Replay] = {}
        self._metrics_hook = metrics_hook

    # ---- registrar lifecycle ---------------------------------------------

    def new_registrar(self, name: str) -> Registrar:
        with self._lock:
            if name in self._registrars:
                raise WatchError(f"registrar for {name} already exists")
            r = Registrar(name, self)
            self._registrars[name] = r
            self._intent[r] = set()
            return r

    def remove_registrar(self, name: str):
        with self._lock:
            r = self._registrars.pop(name, None)
            if r is None:
                return
            for gvk in list(self._intent.get(r, ())):
                self._remove_watch_locked(r, gvk)
            self._intent.pop(r, None)

    # ---- watch bookkeeping ------------------------------------------------

    def _add_watch(self, r: Registrar, gvk: GVK):
        with self._lock:
            if gvk in self._intent[r]:
                return
            self._intent[r].add(gvk)
            if gvk not in self._pumps:
                pump = _Pump(self, gvk)
                self._pumps[gvk] = pump
                pump.start()
            # async replay of current objects to the late joiner
            # (replay.go:35-120): the snapshot list runs off the manager
            # lock so a slow/large list never stalls live fan-out; the
            # replay gate installed here preserves the no-stale-resurrection
            # ordering (see _Replay docstring)
            replay = _Replay(self, r, gvk)
            self._replays[(r.name, gvk)] = replay
            replay.start()
            self._report()

    def _remove_watch(self, r: Registrar, gvk: GVK):
        with self._lock:
            self._remove_watch_locked(r, gvk)

    def _remove_watch_locked(self, r: Registrar, gvk: GVK):
        self._intent.get(r, set()).discard(gvk)
        replay = self._replays.pop((r.name, gvk), None)
        if replay is not None:
            replay.cancel()  # teardown during replay: drop snapshot+buffer
        if not any(gvk in s for s in self._intent.values()):
            pump = self._pumps.pop(gvk, None)
            if pump:
                pump.stop()  # last registrar left: stop the informer
        self._report()

    def _replace_watch(self, r: Registrar, desired: Set[GVK]):
        with self._lock:
            current = set(self._intent.get(r, ()))
        for gvk in current - desired:
            self._remove_watch(r, gvk)
        for gvk in desired - current:
            self._add_watch(r, gvk)

    def _fan_out(self, gvk: GVK, ev: WatchEvent):
        with self._lock:
            # buffer-vs-deliver decided under the lock, atomically with the
            # replay's final splice: a registrar mid-replay buffers (the
            # splice re-orders it after the snapshot), everyone else gets
            # the event directly
            targets = []
            for r, s in self._intent.items():
                if gvk not in s:
                    continue
                replay = self._replays.get((r.name, gvk))
                if replay is not None and not replay.cancelled.is_set():
                    replay.pending.append(ev)
                else:
                    targets.append(r)
        for r in targets:
            r.events.put((gvk, ev))

    def _report(self):
        if self._metrics_hook:
            try:
                self._metrics_hook(len(self._pumps), self.intended().size())
            except Exception:
                import logging

                logging.getLogger("gatekeeper_tpu_torch.watch").debug(
                    "watch metrics hook failed", exc_info=True
                )

    # ---- introspection ----------------------------------------------------

    def replays_active(self) -> int:
        """In-flight late-joiner replays (drain/quiesce helpers must treat
        a pending replay as undelivered events)."""
        with self._lock:
            return len(self._replays)

    def watched_gvks(self) -> GVKSet:
        with self._lock:
            return GVKSet(self._pumps.keys())

    def intended(self) -> GVKSet:
        with self._lock:
            out: Set[GVK] = set()
            for s in self._intent.values():
                out |= s
            return GVKSet(out)

    def watched_by(self, r: Registrar) -> GVKSet:
        with self._lock:
            return GVKSet(self._intent.get(r, ()))

    def stop(self):
        with self._lock:
            for replay in self._replays.values():
                replay.cancel()
            self._replays.clear()
            for pump in self._pumps.values():
                pump.stop()
            self._pumps.clear()
