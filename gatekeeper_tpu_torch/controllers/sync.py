"""Sync (data replication) reconciler (reference
pkg/controller/sync/sync_controller.go).

Fed by the dynamic watches the config controller installs: every event for a
synced GVK replicates the object into the engine inventory (add_data) or
removes it on deletion.  Namespaces excluded for the `sync` process are
skipped; writes for GVKs that leave the sync set are dropped
(FilteredDataClient, opadataclient.go:32-69).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Set, Tuple

from ..kube.inmem import InMemoryKube, WatchEvent
from ..process.excluder import SYNC, Excluder
from ..readiness.tracker import Tracker
from .base import GVK, Controller


class SyncController(Controller):
    name = "sync"

    def __init__(
        self,
        kube: InMemoryKube,
        client,
        excluder: Excluder,
        tracker: Optional[Tracker] = None,
        switch=None,
        reporter=None,
    ):
        super().__init__(switch)
        self.kube = kube
        self.client = client
        self.excluder = excluder
        self.tracker = tracker
        self.reporter = reporter
        self._lock = threading.Lock()
        # metrics state: per-GVK synced object counts (stats_reporter.go)
        self._counts: Dict[GVK, int] = {}
        self._synced: Set[Tuple[GVK, str, str]] = set()

    def allowed(self, gvk: GVK) -> bool:
        """FilteredDataClient: only GVKs in the registrar's current watch
        set replicate (drops late events for removed kinds)."""
        return self.registrar is None or self.registrar.watched().contains(gvk)

    def reconcile(self, gvk: GVK, event: WatchEvent):
        obj = event.object
        meta = obj.get("metadata") or {}
        ns = meta.get("namespace") or ""
        name = meta.get("name") or ""
        key = (gvk, ns, name)
        t0 = time.monotonic()
        if not self.allowed(gvk):
            return
        if event.type == "DELETED":
            self.client.remove_data(obj)
            with self._lock:
                if key in self._synced:
                    self._synced.discard(key)
                    self._counts[gvk] = max(0, self._counts.get(gvk, 0) - 1)
            if self.tracker:
                self.tracker.for_data(gvk).cancel_expect(obj)
        else:
            if self.excluder.is_namespace_excluded(SYNC, ns):
                # excluded objects must not block readiness: the tracker
                # expected them from the raw List (sync_controller.go calls
                # CancelExpect on the skip path)
                if self.tracker:
                    self.tracker.for_data(gvk).cancel_expect(obj)
                return
            self.client.add_data(obj)
            with self._lock:
                if key not in self._synced:
                    self._synced.add(key)
                    self._counts[gvk] = self._counts.get(gvk, 0) + 1
            if self.tracker:
                self.tracker.for_data(gvk).observe(obj)
        if self.reporter:
            self.reporter.report_sync(self.counts(), time.monotonic() - t0)

    def counts(self) -> Dict[GVK, int]:
        with self._lock:
            return dict(self._counts)

    def prune(self):
        """Drop bookkeeping for GVKs that left the sync set — their engine
        data was wiped by the config controller and their DELETED events are
        filtered by allowed(), so counts would otherwise stick forever."""
        if self.registrar is None:
            return
        watched = self.registrar.watched()
        with self._lock:
            for gvk in [g for g in self._counts if not watched.contains(g)]:
                del self._counts[gvk]
            self._synced = {k for k in self._synced if watched.contains(k[0])}
        if self.reporter:
            self.reporter.report_sync(self.counts())
