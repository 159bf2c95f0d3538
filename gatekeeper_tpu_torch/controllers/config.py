"""Config reconciler (reference pkg/controller/config/config_controller.go).

The Config singleton is the dynamic-config hot path: on change it
(1) swaps the process excluder from spec.match (:263),
(2) wipes all replicated engine data (:268-270),
(3) replaces the sync controller's dynamic watches with spec.sync.syncOnly
    (:278-281), and
(4) replays still-watched data via List+add_data (:294-331) so the engine
    inventory converges without waiting for organic events.
"""

from __future__ import annotations

from typing import Optional

from ..apis.config import CONFIG_NAME, parse_config
from ..kube.inmem import InMemoryKube, WatchEvent
from ..process.excluder import SYNC, Excluder
from ..readiness.tracker import Tracker
from .base import GVK, Controller


class ConfigController(Controller):
    name = "config"

    def __init__(
        self,
        kube: InMemoryKube,
        client,
        sync_registrar,
        excluder: Excluder,
        tracker: Optional[Tracker] = None,
        switch=None,
        reporter=None,
        sync_controller=None,
    ):
        super().__init__(switch)
        self.kube = kube
        self.client = client
        self.sync_registrar = sync_registrar
        self.sync_controller = sync_controller
        self.excluder = excluder
        self.tracker = tracker
        self.reporter = reporter

    def reconcile(self, gvk: GVK, event: WatchEvent):
        obj = event.object
        name = (obj.get("metadata") or {}).get("name", "")
        if name != CONFIG_NAME:
            # only the singleton is honored (pkg/keys/config.go:25)
            return
        if event.type == "DELETED":
            spec = parse_config(None)
            if self.tracker:
                # a config deleted during startup must not block readiness
                self.tracker.config.cancel_expect(obj)
        else:
            spec = parse_config(obj)

        # (1) swap the excluder
        new_ex = Excluder()
        new_ex.add(spec.match)
        if not self.excluder.equals(new_ex):
            self.excluder.replace(new_ex)

        # (2) wipe replicated data — the sync set may have shrunk
        self.client.wipe_data()

        # (3) replace dynamic watches
        sync_gvks = [e.gvk() for e in spec.sync_only]
        if self.sync_registrar is not None:
            self.sync_registrar.replace_watch(sync_gvks)
        if self.sync_controller is not None:
            self.sync_controller.prune()

        # (4) replay: list each still-watched GVK and re-add its objects
        # (the watch replay would also deliver them; doing it inline makes
        # convergence synchronous with the reconcile, as the reference does)
        for g in sync_gvks:
            for o in self.kube.list(g):
                ns = (o.get("metadata") or {}).get("namespace") or ""
                if self.excluder.is_namespace_excluded(SYNC, ns):
                    if self.tracker:
                        self.tracker.for_data(g).cancel_expect(o)
                    continue
                self.client.add_data(o)
                if self.tracker:
                    self.tracker.for_data(g).observe(o)
        if event.type != "DELETED" and self.tracker:
            self.tracker.config.observe(obj)
