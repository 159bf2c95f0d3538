"""ConstraintTemplate reconciler (reference
pkg/controller/constrainttemplate/constrainttemplate_controller.go).

Upsert: write per-pod status (uid/generation/errors), compile + install the
template into the engine (client.add_template), create/update the
constraint CRD object with an owner-ref, register a dynamic watch for the
constraint kind, observe readiness.  Compile errors land in the pod status
(ingestion_controller.go:325-342) and cancel the template's readiness
expectation — they are user errors, not reconcile failures.

Delete: unwind watch -> readiness -> engine (handleDelete, :469-485) and
delete this pod's status objects.
"""

from __future__ import annotations

import time
from typing import Optional

from .. import logging as gklog
from .. import util
from ..apis import status as status_api
from ..client.client import ClientError
from ..kube.inmem import InMemoryKube, NotFound, WatchEvent
from ..readiness.tracker import CONSTRAINTS_GROUP, TEMPLATES_GVK, Tracker
from .base import GVK, Controller

CRD_GVK = ("apiextensions.k8s.io", "v1", "CustomResourceDefinition")


class ConstraintTemplateController(Controller):
    name = "constrainttemplate"

    def __init__(
        self,
        kube: InMemoryKube,
        client,
        constraint_registrar,
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
        self.constraint_registrar = constraint_registrar
        self.tracker = tracker
        self.pod_id = pod_id or util.get_id() or "pod-local"
        self.namespace = namespace
        self.operations = operations
        self.reporter = reporter
        self.get_pod = get_pod

    # ---- reconcile --------------------------------------------------------

    def reconcile(self, gvk: GVK, event: WatchEvent):
        template = event.object
        name = (template.get("metadata") or {}).get("name", "")
        if event.type == "DELETED":
            self._handle_delete(template, name)
            return
        self._handle_upsert(template, name)

    def _constraint_kind(self, template: dict) -> str:
        return (
            util.nested_get(template, "spec", "crd", "spec", "names", "kind")
            or ""
        )

    def _handle_upsert(self, template: dict, name: str):
        t0 = time.monotonic()
        status = status_api.new_template_status_for_pod(
            self.pod_id, self.namespace, template,
            self.operations.assigned_string_list() if self.operations else [],
            owner_pod=self.get_pod() if self.get_pod else None,
        )
        kind = self._constraint_kind(template)
        try:
            crd = self.client.add_template(template)
        except ClientError as e:
            # compile/validation failure: record in status, stop tracking
            status["status"]["errors"] = [
                status_api.status_error("create_error", str(e))
            ]
            self.kube.apply(status)
            if self.tracker:
                self.tracker.cancel_template(template)
            if self.reporter:
                self.reporter.report_ingestion("error", time.monotonic() - t0)
            gklog.log_event(
                self.log, "template ingestion failed",
                **{gklog.TEMPLATE_NAME: name, gklog.DETAILS: str(e)},
            )
            return

        # constraint CRD object, owner-ref'd to the template (:431-455)
        crd_obj = {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata": {
                "name": f"{kind.lower()}.{CONSTRAINTS_GROUP}",
                "ownerReferences": [
                    {
                        "apiVersion": template.get("apiVersion", ""),
                        "kind": "ConstraintTemplate",
                        "name": name,
                        "uid": util.nested_get(template, "metadata", "uid"),
                    }
                ],
            },
            "spec": crd.get("spec", crd),
            "status": {"conditions": [{"type": "Established", "status": "True"}]},
        }
        self.kube.apply(crd_obj)

        # dynamic watch for the constraint kind (:458, :553-561)
        if kind and self.constraint_registrar is not None:
            self.constraint_registrar.add_watch((CONSTRAINTS_GROUP, "v1beta1", kind))

        status["status"]["errors"] = []
        self.kube.apply(status)
        if self.tracker:
            self.tracker.for_gvk(TEMPLATES_GVK).observe(template)
        if self.reporter:
            self.reporter.report_ingestion("active", time.monotonic() - t0)

    def _handle_delete(self, template: dict, name: str):
        kind = self._constraint_kind(template)
        if not kind:
            # template may arrive as a bare tombstone; derive kind from name
            # (framework rule: template name == lower(kind))
            for k in self.client.templates():
                if k.lower() == name:
                    kind = k
                    break
        if kind and self.constraint_registrar is not None:
            self.constraint_registrar.remove_watch(
                (CONSTRAINTS_GROUP, "v1beta1", kind)
            )
        if self.tracker:
            self.tracker.cancel_template(template)
        if kind:
            self.client.remove_template_by_kind(kind)
            self.kube.delete(CRD_GVK, f"{kind.lower()}.{CONSTRAINTS_GROUP}")
        # delete this pod's status object (deleteAllStatus, :487-500)
        try:
            self.kube.delete(
                status_api.TEMPLATE_POD_STATUS_GVK,
                status_api.key_for_template(self.pod_id, name),
                self.namespace,
            )
        except NotFound:
            pass
