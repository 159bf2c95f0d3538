"""Controller runtime: the event-driven reconciler loop.

The reference builds on controller-runtime workqueues (per-controller
serialized reconcile with retry/backoff, SURVEY.md section 2.4).  Here each
controller owns a watch-manager Registrar and one worker thread draining its
event queue; reconcile errors requeue with capped exponential backoff.
Reconcile methods are plain calls so tests can drive them synchronously.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Tuple

from .. import logging as gklog
from ..kube.inmem import WatchEvent
from ..watch.manager import ControllerSwitch, Registrar
from ..util import join_thread

GVK = Tuple[str, str, str]

MAX_RETRIES = 5
BASE_BACKOFF = 0.01


class Controller:
    name = "controller"

    def __init__(self, switch: Optional[ControllerSwitch] = None):
        self.switch = switch
        self.log = gklog.get(self.name)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.registrar: Optional[Registrar] = None

    # ---- the reconcile seam ----------------------------------------------

    def reconcile(self, gvk: GVK, event: WatchEvent) -> None:
        raise NotImplementedError

    def process(self, gvk: GVK, event: WatchEvent) -> None:
        """One guarded reconcile: teardown gate + retry/backoff (the
        reference's workqueue semantics)."""
        if self.switch is not None and not self.switch.enter():
            return
        for attempt in range(MAX_RETRIES):
            try:
                self.reconcile(gvk, event)
                return
            except Exception:
                if attempt == MAX_RETRIES - 1:
                    self.log.exception(
                        "reconcile failed after %d attempts (%s %s)",
                        MAX_RETRIES, gvk, event.type,
                    )
                    return
                time.sleep(BASE_BACKOFF * (2**attempt))

    # ---- worker loop ------------------------------------------------------

    def start(self):
        assert self.registrar is not None, f"{self.name}: no registrar bound"
        # idempotent: a double start must not leak a second worker loop
        # draining the same registrar queue (events would split between
        # the two at random)
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"ctrl-{self.name}"
        )
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                gvk, ev = self.registrar.events.get(timeout=0.1)
            except queue.Empty:
                continue
            self.process(gvk, ev)

    def stop(self):
        self._stop.set()
        if self._thread:
            join_thread(self._thread, 2.0, f"controller {self.name}")
            self._thread = None

    def drain(self, timeout: float = 5.0):
        """Test helper: block until this controller's queue is empty."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.registrar is not None and self.registrar.events.empty():
                return True
            time.sleep(0.01)
        return False
