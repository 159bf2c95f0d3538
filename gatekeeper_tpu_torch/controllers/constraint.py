"""Constraint reconciler (reference
pkg/controller/constraint/constraint_controller.go).

Type-erased: one controller serves every constraint kind; its registrar is
fed dynamically by the template controller (events carry the GVK, the
reference packs it into request names — pkg/util/pack.go).  Upsert validates
against the template-synthesized CRD schema and installs into the engine;
per-pod ConstraintPodStatus records enforcement + errors; a totals cache
feeds the `constraints` metric by (kind, enforcement action, status).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from .. import logging as gklog
from .. import util
from ..apis import status as status_api
from ..client.client import ClientError
from ..kube.inmem import InMemoryKube, NotFound, WatchEvent
from ..readiness.tracker import Tracker
from .base import GVK, Controller


class ConstraintsCache:
    """Per-(kind, action) totals for the constraints metric
    (constraint_controller.go:425-473)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[str, str], Dict[str, str]] = {}

    def add(self, kind: str, name: str, action: str, status: str):
        with self._lock:
            self._cache[(kind, name)] = {"action": action, "status": status}

    def remove(self, kind: str, name: str):
        with self._lock:
            self._cache.pop((kind, name), None)

    def totals(self) -> Dict[Tuple[str, str], int]:
        """-> {(enforcement_action, status): count}"""
        with self._lock:
            out: Dict[Tuple[str, str], int] = {}
            for entry in self._cache.values():
                key = (entry["action"], entry["status"])
                out[key] = out.get(key, 0) + 1
            return out


class ConstraintController(Controller):
    name = "constraint"

    def __init__(
        self,
        kube: InMemoryKube,
        client,
        tracker: Optional[Tracker] = None,
        switch=None,
        pod_id: str = "",
        namespace: str = "gatekeeper-system",
        operations=None,
        reporter=None,
        get_pod=None,
    ):
        super().__init__(switch)
        self.kube = kube
        self.client = client
        self.tracker = tracker
        self.pod_id = pod_id or util.get_id() or "pod-local"
        self.namespace = namespace
        self.operations = operations
        self.cache = ConstraintsCache()
        self.reporter = reporter
        self.get_pod = get_pod

    def reconcile(self, gvk: GVK, event: WatchEvent):
        constraint = event.object
        kind = constraint.get("kind", "")
        name = (constraint.get("metadata") or {}).get("name", "")
        if event.type == "DELETED":
            self.client.remove_constraint(constraint)
            self.cache.remove(kind, name)
            try:
                self.kube.delete(
                    status_api.CONSTRAINT_POD_STATUS_GVK,
                    status_api.key_for_constraint(self.pod_id, constraint),
                    self.namespace,
                )
            except NotFound:
                pass
            self._report()
            return

        action = util.get_enforcement_action(constraint)
        status = status_api.new_constraint_status_for_pod(
            self.pod_id, self.namespace, constraint,
            self.operations.assigned_string_list() if self.operations else [],
            owner_pod=self.get_pod() if self.get_pod else None,
        )
        try:
            self.client.add_constraint(constraint)
        except ClientError as e:
            status["status"]["errors"] = [status_api.status_error("add_error", str(e))]
            status["status"]["enforced"] = False
            self.kube.apply(status)
            self.cache.add(kind, name, action, "error")
            if self.tracker:
                # invalid constraints must not block readiness forever
                self.tracker.for_gvk(gvk).cancel_expect(constraint)
            gklog.log_event(
                self.log, "constraint ingestion failed",
                **{gklog.CONSTRAINT_KIND: kind, gklog.CONSTRAINT_NAME: name,
                   gklog.DETAILS: str(e)},
            )
            self._report()
            return

        status["status"]["enforced"] = True
        self.kube.apply(status)
        self.cache.add(kind, name, action, "active")
        if self.tracker:
            self.tracker.for_gvk(gvk).observe(constraint)
        self._report()

    def _report(self):
        if self.reporter:
            self.reporter.report_constraints(self.cache.totals())
