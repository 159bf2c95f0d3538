"""/v1/admitlabel — the namespace ignore-label guard (reference
pkg/webhook/namespacelabel.go:27-29,69-95).

Only namespaces on the exempt list may carry the
admission.gatekeeper.sh/ignore label; everything else that sets it is
denied.  This webhook is registered failurePolicy=Fail (unlike the policy
webhook, which fails open) because it protects the bypass mechanism itself.
"""

from __future__ import annotations

from typing import Iterable, Optional, Set

from .policy import AdmissionResponse, _allowed, _denied

IGNORE_LABEL = "admission.gatekeeper.sh/ignore"


class NamespaceLabelHandler:
    def __init__(self, exempt_namespaces: Optional[Iterable[str]] = None):
        self.exempt: Set[str] = set(exempt_namespaces or ())

    def add_exempt(self, namespace: str):
        self.exempt.add(namespace)

    def handle(self, req: dict) -> AdmissionResponse:
        if req.get("operation") == "DELETE":
            return _allowed("Delete is always allowed")
        kind = req.get("kind") or {}
        if kind.get("group", "") != "" or kind.get("kind") != "Namespace":
            return _allowed("Not a namespace")
        obj = req.get("object")
        if not isinstance(obj, dict):
            return _denied("while deserializing resource", 500)
        name = (obj.get("metadata") or {}).get("name", "")
        if name in self.exempt:
            return _allowed(
                f"Namespace {name} is allowed to set {IGNORE_LABEL}"
            )
        labels = (obj.get("metadata") or {}).get("labels") or {}
        for label in labels:
            if label == IGNORE_LABEL:
                return AdmissionResponse(
                    False,
                    f"Only exempt namespace can have the {IGNORE_LABEL} label",
                    403,
                )
        return _allowed(f"Namespace is not setting the {IGNORE_LABEL} label")
