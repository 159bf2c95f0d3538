"""Storage-version upgrade manager (reference pkg/upgrade/manager.go).

On start, migrates every stored v1alpha1 gatekeeper resource (constraints
and templates) to the served v1beta1 storage version.  The reference does
this with no-op Updates that make the API server rewrite the stored version
(manager.go:113-125); against the in-memory store the rewrite is explicit:
the object moves to the v1beta1 GVK bucket with apiVersion bumped, uid and
spec preserved.
"""

from __future__ import annotations

import threading
from typing import Tuple

from .. import logging as gklog
from ..kube.inmem import InMemoryKube

log = gklog.get("upgrade")

GVK = Tuple[str, str, str]

MIGRATE_GROUPS = ("constraints.gatekeeper.sh", "templates.gatekeeper.sh")
OLD_VERSION = "v1alpha1"
NEW_VERSION = "v1beta1"


class UpgradeManager:
    def __init__(self, kube: InMemoryKube):
        self.kube = kube
        self._thread = None

    def upgrade(self) -> int:
        """Migrate all v1alpha1 objects; returns count migrated."""
        migrated = 0
        for gvk in self.kube.list_gvks():
            group, version, kind = gvk
            if group not in MIGRATE_GROUPS or version != OLD_VERSION:
                continue
            for obj in self.kube.list(gvk):
                meta = obj.get("metadata") or {}
                name = meta.get("name", "")
                ns = meta.get("namespace") or ""
                new_obj = dict(obj)
                new_obj["apiVersion"] = f"{group}/{NEW_VERSION}"
                new_gvk = (group, NEW_VERSION, kind)
                try:
                    # already present at the new version: old copy is stale
                    self.kube.get(new_gvk, name, ns)
                except Exception:
                    self.kube.apply(new_obj)
                self.kube.delete(gvk, name, ns)
                migrated += 1
                log.info(
                    "migrated %s/%s %s/%s to %s",
                    group, kind, ns, name, NEW_VERSION,
                )
        return migrated

    def start(self):
        """Async on-start migration (upgrade controller.go adds the manager
        as a Runnable).  Idempotent: one migration pass per process — a
        second start() while (or after) the first runs is a no-op."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="upgrade", daemon=True
        )
        self._thread.start()

    def _run(self):
        try:
            self.upgrade()
        except Exception:
            log.exception("storage version migration failed")

    def join(self, timeout: float = 5.0):
        if self._thread:
            self._thread.join(timeout=timeout)
