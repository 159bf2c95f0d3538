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

        # (2) replace dynamic watches
        sync_gvks = [e.gvk() for e in spec.sync_only]
        if self.sync_registrar is not None:
            self.sync_registrar.replace_watch(sync_gvks)
        if self.sync_controller is not None:
            self.sync_controller.prune()

        # (3) drop the replicated data the new config no longer keeps —
        # the sync set may have shrunk, the excluder grown.  Where the
        # JAX package wipes everything before (2), the port removes only
        # those objects, after (2): the replay below re-adds the rest at
        # an unchanged resourceVersion, which the store dedups, so an
        # inventory restored from a snapshot before the controllers start
        # keeps its packed rows and delta basis.  The watches are live
        # before the listing, so an object deleted after it still gets
        # its DELETED, and one created after it and dropped here comes
        # back with the replay: the store ends as after a wipe and a
        # replay.  The listing is metadata-only where the kube surface
        # offers it (list_rvs)
        keep = set()
        for g in sync_gvks:
            api = f"{g[0]}/{g[1]}" if g[0] else g[1]
            if hasattr(self.kube, "list_rvs"):
                keys = self.kube.list_rvs(g)
            else:
                keys = [((o.get("metadata") or {}).get("namespace") or "",
                         (o.get("metadata") or {}).get("name"))
                        for o in self.kube.list(g)]
            for ns, name in keys:
                if not self.excluder.is_namespace_excluded(SYNC, ns):
                    keep.add((api, g[2], name, ns))
        for _obj, api, kind, name, ns in list(
                self.client.driver.store.iter_objects()):
            if (api, kind, name, ns) not in keep:
                self.client.remove_data({
                    "apiVersion": api, "kind": kind,
                    "metadata": {"name": name, "namespace": ns},
                })

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
