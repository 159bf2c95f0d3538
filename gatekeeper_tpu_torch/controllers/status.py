"""Status aggregation controllers (reference
pkg/controller/constraintstatus/constraintstatus_controller.go and
pkg/controller/constrainttemplatestatus/).

Every pod writes per-object ConstraintPodStatus / ConstraintTemplatePodStatus
CRs; these controllers map a status event back to its parent (via the
internal.gatekeeper.sh labels), list ALL pods' statuses for that parent, and
fold them — sorted by pod id — into the parent's status.byPod.  Statuses
whose recorded UID no longer matches the live parent are dropped (drift
detection, constraintpodstatus_types.go:44-47)."""

from __future__ import annotations

from typing import Optional

from ..apis import status as status_api
from ..kube.inmem import InMemoryKube, NotFound, WatchEvent
from ..readiness.tracker import CONSTRAINTS_GROUP
from .base import GVK, Controller

TEMPLATES_API = "templates.gatekeeper.sh/v1beta1"


class ConstraintStatusController(Controller):
    name = "constraintstatus"

    def __init__(self, kube: InMemoryKube, switch=None,
                 namespace: str = "gatekeeper-system"):
        super().__init__(switch)
        self.kube = kube
        self.namespace = namespace

    def reconcile(self, gvk: GVK, event: WatchEvent):
        labels = (event.object.get("metadata") or {}).get("labels") or {}
        kind = labels.get(status_api.CONSTRAINT_KIND_LABEL)
        name = labels.get(status_api.CONSTRAINT_NAME_LABEL)
        if not kind or not name:
            return
        cgvk = (CONSTRAINTS_GROUP, "v1beta1", kind)
        try:
            parent = self.kube.get(cgvk, name)
        except NotFound:
            return  # parent gone; nothing to fold into
        parent_uid = (parent.get("metadata") or {}).get("uid")
        by_pod = []
        for st in self.kube.list(status_api.CONSTRAINT_POD_STATUS_GVK, self.namespace):
            l = (st.get("metadata") or {}).get("labels") or {}
            if l.get(status_api.CONSTRAINT_KIND_LABEL) != kind:
                continue
            if l.get(status_api.CONSTRAINT_NAME_LABEL) != name:
                continue
            s = st.get("status") or {}
            # UID drift: status written for a deleted+recreated constraint
            if parent_uid and s.get("constraintUID") and s["constraintUID"] != parent_uid:
                continue
            by_pod.append(s)
        by_pod.sort(key=lambda s: s.get("id", ""))
        parent.setdefault("status", {})["byPod"] = by_pod
        # optimistic concurrency: a concurrent spec writer bumps the
        # resourceVersion; Conflict propagates to the controller retry
        # loop, which re-reads the fresh parent instead of clobbering it.
        # Status().Update (constraintstatus_controller.go:222).
        self.kube.update(parent, check_version=True, subresource="status")


class ConstraintTemplateStatusController(Controller):
    name = "constrainttemplatestatus"

    def __init__(self, kube: InMemoryKube, switch=None,
                 namespace: str = "gatekeeper-system"):
        super().__init__(switch)
        self.kube = kube
        self.namespace = namespace

    def reconcile(self, gvk: GVK, event: WatchEvent):
        labels = (event.object.get("metadata") or {}).get("labels") or {}
        name = labels.get(status_api.TEMPLATE_NAME_LABEL)
        if not name:
            return
        tgvk = ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
        try:
            parent = self.kube.get(tgvk, name)
        except NotFound:
            return
        parent_uid = (parent.get("metadata") or {}).get("uid")
        by_pod = []
        for st in self.kube.list(status_api.TEMPLATE_POD_STATUS_GVK, self.namespace):
            l = (st.get("metadata") or {}).get("labels") or {}
            if l.get(status_api.TEMPLATE_NAME_LABEL) != name:
                continue
            s = st.get("status") or {}
            if parent_uid and s.get("templateUID") and s["templateUID"] != parent_uid:
                continue
            by_pod.append(s)
        by_pod.sort(key=lambda s: s.get("id", ""))
        parent.setdefault("status", {})
        parent["status"]["byPod"] = by_pod
        # created = every pod ingested without errors (template status
        # controller sets .status.created)
        parent["status"]["created"] = bool(by_pod) and all(
            not s.get("errors") for s in by_pod
        )
        # Status().Update (constrainttemplatestatus_controller.go:196)
        self.kube.update(parent, check_version=True, subresource="status")
