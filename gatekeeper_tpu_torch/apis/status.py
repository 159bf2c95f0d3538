"""Per-pod status CR types + key packing (reference apis/status/v1beta1/).

Each pod writes one ConstraintPodStatus per constraint and one
ConstraintTemplatePodStatus per template; aggregation controllers fold them
into the parent object's status.byPod.  Status object names pack
(pod, kind, name) with dash-escaping (util.go:28-91); labels carry the parts
for label-selected listing (constraintpodstatus_types.go:32-37).
"""

from __future__ import annotations

from typing import List

STATUS_GROUP = "status.gatekeeper.sh"
STATUS_VERSION = "v1beta1"

CONSTRAINT_POD_STATUS_GVK = (STATUS_GROUP, STATUS_VERSION, "ConstraintPodStatus")
TEMPLATE_POD_STATUS_GVK = (STATUS_GROUP, STATUS_VERSION, "ConstraintTemplatePodStatus")

CONSTRAINT_NAME_LABEL = "internal.gatekeeper.sh/constraint-name"
CONSTRAINT_KIND_LABEL = "internal.gatekeeper.sh/constraint-kind"
TEMPLATE_NAME_LABEL = "internal.gatekeeper.sh/constrainttemplate-name"
POD_LABEL = "internal.gatekeeper.sh/pod"

CONSTRAINTS_GROUP = "constraints.gatekeeper.sh"
TEMPLATES_GROUP = "templates.gatekeeper.sh"


class KeyError_(ValueError):
    pass


def dash_pack(*vals: str) -> str:
    """dashPacker (util.go:55-91): join with '-', escaping '-' as '--'.
    Empty strings and leading/trailing dashes are rejected, as upstream."""
    if not vals:
        raise KeyError_("cannot pack an empty list of strings")
    out = []
    for v in vals:
        if not v:
            raise KeyError_("cannot pack empty strings")
        if v.startswith("-") or v.endswith("-"):
            raise KeyError_(f"cannot pack strings that begin or end with a dash: {vals}")
        out.append(v.replace("-", "--"))
    return "-".join(out)


def dash_unpack(val: str) -> List[str]:
    """dashExtractor (util.go:29-53)."""
    tokens: List[str] = []
    buf: List[str] = []
    prev_dash = False
    for ch in val:
        if prev_dash and ch != "-":
            tokens.append("".join(buf))
            buf = []
            prev_dash = False
        if ch == "-":
            if prev_dash:
                buf.append(ch)
                prev_dash = False
            else:
                prev_dash = True
            continue
        buf.append(ch)
    tokens.append("".join(buf))
    return tokens


def key_for_constraint(pod_id: str, constraint: dict) -> str:
    """KeyForConstraint (constraintpodstatus_types.go:113-123): the resource
    name is dashPack(pod, lower(kind), name)."""
    kind = (constraint.get("kind") or "").lower()
    name = (constraint.get("metadata") or {}).get("name") or ""
    return dash_pack(pod_id, kind, name)


def key_for_template(pod_id: str, template_name: str) -> str:
    """KeyForConstraintTemplate (constrainttemplatepodstatus_types.go)."""
    return dash_pack(pod_id, template_name)


# Pod ownership of status CRs: when enabled (default) and the owning Pod
# is known, status resources carry an ownerReference to it so they are
# garbage-collected with the pod (constraintpodstatus_types.go:104-108).
# --debug-use-fake-pod disables it to run outside Kubernetes
# (reference apis/status/v1beta1/util.go DisablePodOwnership).
_POD_OWNERSHIP = True


def disable_pod_ownership():
    global _POD_OWNERSHIP
    _POD_OWNERSHIP = False


def pod_ownership_enabled() -> bool:
    return _POD_OWNERSHIP


def _maybe_own(meta: dict, owner_pod) -> dict:
    if _POD_OWNERSHIP and owner_pod:
        meta["ownerReferences"] = [
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "name": (owner_pod.get("metadata") or {}).get("name", ""),
                "uid": (owner_pod.get("metadata") or {}).get("uid", ""),
            }
        ]
    return meta


def new_constraint_status_for_pod(
    pod_id: str, namespace: str, constraint: dict, operations: List[str],
    owner_pod: dict = None,
) -> dict:
    """NewConstraintStatusForPod (constraintpodstatus_types.go:86-111) as an
    unstructured dict ready for the in-memory API."""
    kind = constraint.get("kind") or ""
    name = (constraint.get("metadata") or {}).get("name") or ""
    uid = (constraint.get("metadata") or {}).get("uid") or ""
    return {
        "apiVersion": f"{STATUS_GROUP}/{STATUS_VERSION}",
        "kind": "ConstraintPodStatus",
        "metadata": _maybe_own({
            "name": key_for_constraint(pod_id, constraint),
            "namespace": namespace,
            "labels": {
                CONSTRAINT_NAME_LABEL: name,
                CONSTRAINT_KIND_LABEL: kind,
                POD_LABEL: pod_id,
                TEMPLATE_NAME_LABEL: kind.lower(),
            },
        }, owner_pod),
        "status": {
            "id": pod_id,
            "constraintUID": uid,
            "operations": list(operations),
            "enforced": False,
            "errors": [],
            "observedGeneration": (constraint.get("metadata") or {}).get("generation", 0),
        },
    }


def new_template_status_for_pod(
    pod_id: str, namespace: str, template: dict, operations: List[str],
    owner_pod: dict = None,
) -> dict:
    """NewConstraintTemplateStatusForPod as an unstructured dict."""
    name = (template.get("metadata") or {}).get("name") or ""
    uid = (template.get("metadata") or {}).get("uid") or ""
    return {
        "apiVersion": f"{STATUS_GROUP}/{STATUS_VERSION}",
        "kind": "ConstraintTemplatePodStatus",
        "metadata": _maybe_own({
            "name": key_for_template(pod_id, name),
            "namespace": namespace,
            "labels": {
                TEMPLATE_NAME_LABEL: name,
                POD_LABEL: pod_id,
            },
        }, owner_pod),
        "status": {
            "id": pod_id,
            "templateUID": uid,
            "operations": list(operations),
            "errors": [],
            "observedGeneration": (template.get("metadata") or {}).get("generation", 0),
        },
    }


def status_error(code: str, message: str, location: str = "") -> dict:
    """Error (constraintpodstatus_types.go:55-60)."""
    out = {"code": code, "message": message}
    if location:
        out["location"] = location
    return out
