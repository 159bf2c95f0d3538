"""Inline render-parity corpus: PSP- and agilebank-family templates with
original Rego, self-contained, plus adversarial resources — unicode
everywhere, missing fields, malformed shapes.

The port's copy of tests/render_corpus.py (equal to it but for this
docstring and the package name, tests/test_torch_copies.py), so that
tools/check_render_parity_torch.py reads it without importing the JAX
package.  The corpus deliberately spans all three render-plan classes
(static / slots / interp) so both the compiled pipeline and the
interpreter fallback are exercised.

Every entry: (name, template dict, constraint dict, expected plan tier or
None when unasserted).
"""

from gatekeeper_tpu_torch.ops.renderplan import INTERP, SLOTS, STATIC


def _template(kind: str, rego: str) -> dict:
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": kind.lower()},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind}}},
            "targets": [
                {"target": "admission.k8s.gatekeeper.sh", "rego": rego}
            ],
        },
    }


def _constraint(kind: str, params: dict, name=None) -> dict:
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name or f"c-{kind.lower()}"},
        "spec": {
            "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
            "parameters": params,
        },
    }


# ---- psp family -------------------------------------------------------------

_PSP_PRIVILEGED = """
package k8spspprivileged

violation[{"msg": msg, "details": {}}] {
  c := input_containers[_]
  c.securityContext.privileged
  msg := sprintf("Privileged container is not allowed: %v, securityContext: %v", [c.name, c.securityContext])
}

input_containers[c] {
  c := input.review.object.spec.containers[_]
}

input_containers[c] {
  c := input.review.object.spec.initContainers[_]
}
"""

_PSP_HOST_NAMESPACE = """
package k8spsphostnamespace

violation[{"msg": msg, "details": {}}] {
  input_share_hostnamespace(input.review.object)
  msg := sprintf("Sharing the host namespace is not allowed: %v", [input.review.object.metadata.name])
}

input_share_hostnamespace(o) {
  o.spec.hostPID
}

input_share_hostnamespace(o) {
  o.spec.hostIPC
}
"""

_PSP_HOST_NETWORK = """
package k8spsphostnetworkingports

violation[{"msg": msg, "details": {}}] {
  input.review.object.spec.hostNetwork
  msg := sprintf("The specified hostNetwork and hostPort are not allowed, pod: %v", [input.review.object.metadata.name])
}

violation[{"msg": msg, "details": {}}] {
  c := input_containers[_]
  p := c.ports[_].hostPort
  p < input.parameters.min
  msg := sprintf("The specified hostNetwork and hostPort are not allowed, pod: %v", [input.review.object.metadata.name])
}

violation[{"msg": msg, "details": {}}] {
  c := input_containers[_]
  p := c.ports[_].hostPort
  p > input.parameters.max
  msg := sprintf("The specified hostNetwork and hostPort are not allowed, pod: %v", [input.review.object.metadata.name])
}

input_containers[c] {
  c := input.review.object.spec.containers[_]
}
"""

# ---- agilebank family -------------------------------------------------------

_REQUIRED_LABELS = """
package k8srequiredlabels

violation[{"msg": msg, "details": {"missing_labels": missing}}] {
  provided := {label | input.review.object.metadata.labels[label]}
  required := {label | label := input.parameters.labels[_]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("you must provide labels: %v", [missing])
}
"""

_ALLOWED_REPOS = """
package k8sallowedrepos

violation[{"msg": msg}] {
  c := input.review.object.spec.containers[_]
  satisfied := [good | repo = input.parameters.repos[_]; good = startswith(c.image, repo)]
  not any(satisfied)
  msg := sprintf("container <%v> has an invalid image repo <%v>, allowed repos are %v", [c.name, c.image, input.parameters.repos])
}
"""

_VOLUME_TYPES = """
package k8spspvolumetypes

violation[{"msg": msg, "details": {}}] {
  fields := {f | input.review.object.spec.volumes[_][f]; f != "name"}
  not input_volume_type_allowed(fields)
  msg := sprintf("The volume types %v are not allowed", [fields])
}

input_volume_type_allowed(fields) {
  input.parameters.volumes[_] == "*"
}

input_volume_type_allowed(fields) {
  allowed := {t | t = input.parameters.volumes[_]}
  extra := fields - allowed
  count(extra) == 0
}
"""

# static-message family: the message reads only parameters
_DENY_ALL = """
package k8sdenyall

violation[{"msg": msg}] {
  input.review.object.spec.hostPID
  msg := sprintf("hostPID is forbidden by policy %v", [input.parameters.policy])
}
"""

_DISALLOWED_TAGS = """
package k8sdisallowedtags

violation[{"msg": msg}] {
  c := input.review.object.spec.containers[_]
  matched := [hit | tag = input.parameters.tags[_]; hit = endswith(c.image, tag)]
  any(matched)
  msg := sprintf("container <%v> uses a disallowed tag <%v>; disallowed tags are %v", [c.name, c.image, input.parameters.tags])
}
"""

_HOST_FILESYSTEM = """
package k8spsphostfilesystem

violation[{"msg": msg, "details": {}}] {
  v := input.review.object.spec.volumes[_]
  v.hostPath
  msg := sprintf("HostPath volume %v is not allowed, pod: %v", [v, input.review.object.metadata.name])
}
"""

_IMAGE_DIGESTS = """
package k8simagedigests

violation[{"msg": msg}] {
  c := input.review.object.spec.containers[_]
  not re_match("@sha256:[a-f0-9]+$", c.image)
  msg := sprintf("container <%v> image <%v> uses a tag, not a digest", [c.name, c.image])
}
"""

_DENY_NAME = """
package k8sdenyname

violation[{"msg": msg}] {
  input.review.object.metadata.name == input.parameters.name
  msg := sprintf("objects named %v are denied", [input.parameters.name])
}
"""

# dynamic family: message built through an unrecognized call chain ->
# interpreter class; ALSO semantically out of the vectorized fragment
_DYNAMIC_MSG = """
package k8sdynamicmsg

violation[{"msg": msg}] {
  c := input.review.object.spec.containers[_]
  c.securityContext.privileged
  parts := split(c.image, ":")
  msg := sprintf("privileged image %v", [parts[0]])
}
"""


def corpus():
    return [
        ("psp-privileged", _template("K8sPSPPrivileged", _PSP_PRIVILEGED),
         _constraint("K8sPSPPrivileged", {}), SLOTS),
        ("psp-host-namespace",
         _template("K8sPSPHostNamespace", _PSP_HOST_NAMESPACE),
         _constraint("K8sPSPHostNamespace", {}), SLOTS),
        # nested per-entity array iteration (ports under containers) is
        # outside the vectorized fragment: a REALISTIC interpreter-tier
        # template, exercising the fallback path end to end
        ("psp-host-network",
         _template("K8sPSPHostNetwork", _PSP_HOST_NETWORK),
         _constraint("K8sPSPHostNetwork", {"min": 80, "max": 9000}),
         INTERP),
        ("disallowed-tags",
         _template("K8sDisallowedTags", _DISALLOWED_TAGS),
         _constraint("K8sDisallowedTags", {"tags": [":latest", ":dev"]}),
         SLOTS),
        ("host-filesystem",
         _template("K8sPSPHostFilesystem", _HOST_FILESYSTEM),
         _constraint("K8sPSPHostFilesystem", {}), SLOTS),
        ("image-digests", _template("K8sImageDigests", _IMAGE_DIGESTS),
         _constraint("K8sImageDigests", {}), SLOTS),
        ("deny-name", _template("K8sDenyName", _DENY_NAME),
         _constraint("K8sDenyName", {"name": "bad-pod"}), STATIC),
        ("required-labels",
         _template("K8sRequiredLabels", _REQUIRED_LABELS),
         _constraint("K8sRequiredLabels",
                     {"labels": ["owner", "billing", "ütf-läbel"]}), SLOTS),
        ("allowed-repos", _template("K8sAllowedRepos", _ALLOWED_REPOS),
         _constraint("K8sAllowedRepos",
                     {"repos": ["safe.io/", "registry.corp/"]}), SLOTS),
        ("volume-types", _template("K8sPSPVolumeTypes", _VOLUME_TYPES),
         _constraint("K8sPSPVolumeTypes",
                     {"volumes": ["configMap", "emptyDir"]}), SLOTS),
        ("deny-all-static", _template("K8sDenyAll", _DENY_ALL),
         _constraint("K8sDenyAll", {"policy": "no-host-pid"}), STATIC),
        ("dynamic-msg", _template("K8sDynamicMsg", _DYNAMIC_MSG),
         _constraint("K8sDynamicMsg", {}), INTERP),
        # missing-parameter edge: required param absent -> the msg ref is
        # undefined, so the clause must never fire (both tiers)
        ("allowed-repos-no-params",
         _template("K8sAllowedRepos2", _ALLOWED_REPOS.replace(
             "k8sallowedrepos", "k8sallowedrepos2")),
         _constraint("K8sAllowedRepos2", {}), None),
        ("required-labels-no-params",
         _template("K8sRequiredLabels2", _REQUIRED_LABELS.replace(
             "k8srequiredlabels", "k8srequiredlabels2")),
         _constraint("K8sRequiredLabels2", {}), None),
    ]


def resources():
    """Adversarial resource set: unicode, missing fields, empty lists,
    type confusion, multi-slot duplicates."""
    return [
        # ordinary violating pod
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "bad-pod", "namespace": "default",
                      "labels": {"owner": "me"}},
         "spec": {"hostPID": True, "hostNetwork": True,
                  "containers": [
                      {"name": "nginx", "image": "evil.io/nginx:latest",
                       "securityContext": {"privileged": True},
                       "ports": [{"hostPort": 31337}]},
                      {"name": "side", "image": "safe.io/side:1"},
                  ],
                  "volumes": [{"name": "v", "hostPath": {"path": "/"}}]}},
        # unicode names / labels / images
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "pöd-ünicode-🚀",
                      "namespace": "défault",
                      "labels": {"ütf-läbel": "präsent", "owner": "陈"}},
         "spec": {"hostIPC": True,
                  "containers": [
                      {"name": "contäiner-ß",
                       "image": "ünsafe.io/рус:v1",
                       "securityContext": {"privileged": True}}]}},
        # missing fields everywhere
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "minimal"},
         "spec": {}},
        # containers without names/images; securityContext without the flag
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "partial", "labels": {}},
         "spec": {"containers": [
             {"securityContext": {"privileged": True}},
             {"name": "x", "securityContext": {}},
             {"name": "y", "image": "evil.io/y",
              "ports": [{"containerPort": 80}]},
         ]}},
        # duplicate containers (identical msg dedup), empty label VALUES,
        # false-valued label (excluded from the provided-keys set)
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "dup",
                      "labels": {"owner": "", "billing": False}},
         "spec": {"containers": [
             {"name": "same", "image": "evil.io/same",
              "securityContext": {"privileged": True}},
             {"name": "same", "image": "evil.io/same",
              "securityContext": {"privileged": True}},
         ],
             "initContainers": [
             {"name": "same", "image": "evil.io/same",
              "securityContext": {"privileged": True}}]}},
        # type confusion: hostPort as string, privileged as string
        # (truthy!), volumes entry with extra keys
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "confused", "labels": {"owner": "o",
                                                     "billing": "b"}},
         "spec": {"containers": [
             {"name": "c1", "image": "registry.corp/ok:1",
              "securityContext": {"privileged": "yes"},
              "ports": [{"hostPort": "8080"}]}],
             "volumes": [
             {"name": "v0", "emptyDir": {}, "nfs": {"server": "s"}}]}},
        # compliant pod (no violations anywhere)
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "good",
                      "labels": {"owner": "o", "billing": "b",
                                 "ütf-läbel": "x"}},
         "spec": {"containers": [
             {"name": "ok", "image": "safe.io/app:2",
              "ports": [{"hostPort": 443}]}],
             "volumes": [{"name": "v0", "emptyDir": {}}]}},
    ]


def review_of(obj, namespace=None):
    r = {
        "kind": {"group": "", "version": "v1",
                 "kind": obj.get("kind", "Pod")},
        "name": obj.get("metadata", {}).get("name", ""),
        "operation": "CREATE",
        "object": obj,
    }
    ns = namespace or obj.get("metadata", {}).get("namespace")
    if ns:
        r["namespace"] = ns
    return r


# ---- referential (cross-resource join) scenarios ---------------------------
# Rendered through the interpreter with a real inventory (join plans
# produce the mask; rendering is the oracle by construction), so the
# parity suite drives these end-to-end driver-vs-oracle instead of
# plan.apply().  Each entry: (name, template, constraint, objects) where
# `objects` is the inventory the scenario audits.

_JOIN_UNIQUE_HOST = """
package k8suniqueingresshost

violation[{"msg": msg}] {
  host := input.review.object.spec.rules[_].host
  other := data.inventory.namespace[_][_]["Ingress"][_]
  otherhost := other.spec.rules[_].host
  host == otherhost
  not identical(other, input.review)
  msg := sprintf("duplicate ingress host: %v", [host])
}

identical(obj, review) {
  obj.metadata.namespace == review.object.metadata.namespace
  obj.metadata.name == review.object.metadata.name
}
"""

_JOIN_REQUIRED_CLASS = """
package k8srequiredstorageclass

violation[{"msg": msg}] {
  class := input.review.object.spec.storageClassName
  not class_exists(class)
  msg := sprintf("storage class %v does not exist", [class])
}

class_exists(name) {
  sc := data.inventory.cluster[_]["StorageClass"][_]
  sc.metadata.name == name
}
"""

_JOIN_TEAM_QUOTA = """
package k8steamquota

violation[{"msg": msg}] {
  team := input.review.object.metadata.labels.team
  n := count({[ns, ident] | p := data.inventory.namespace[ns][_]["Pod"][ident]; p.metadata.labels.team == team})
  n > input.parameters.limit
  msg := sprintf("team %v has %v pods (limit %v)", [team, n, input.parameters.limit])
}
"""


def _ingress(name, ns, hosts):
    return {
        "apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
        "metadata": {"name": name, "namespace": ns},
        "spec": {"rules": [{"host": h} for h in hosts]},
    }


def _join_match(kind_name, groups):
    return {"kinds": [{"apiGroups": groups, "kinds": [kind_name]}]}


def join_corpus():
    """Referential scenarios for the parity suite: unicode hosts,
    duplicate slots within one object (self never duplicates itself),
    dangling and present references, and int-vs-str quota keys (the
    interned-key normalization satellite)."""
    unique_objs = [
        _ingress("ing-a", "ns-1", ["app.corp.io", "dup-🌍.corp.io"]),
        _ingress("ing-b", "ns-2", ["dup-🌍.corp.io"]),
        _ingress("ing-c", "ns-1", ["solo.corp.io", "solo.corp.io"]),
        _ingress("ing-d", "défault", ["ünïque.corp.io"]),
    ]
    class_objs = [
        {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
         "metadata": {"name": "standard"}},
        {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
         "metadata": {"name": "ok", "namespace": "ns-1"},
         "spec": {"storageClassName": "standard"}},
        {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
         "metadata": {"name": "dangling-ütf", "namespace": "ns-1"},
         "spec": {"storageClassName": "missing-klässe"}},
        {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
         "metadata": {"name": "no-field", "namespace": "ns-1"},
         "spec": {}},
    ]
    quota_objs = [
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": f"q-{i}", "namespace": "ns-1",
                      "labels": {"team": team}},
         "spec": {}}
        for i, team in enumerate([5, 5, 5, "5", "tëam-ü", "tëam-ü"])
    ]
    unique_t = _template("K8sUniqueIngressHost", _JOIN_UNIQUE_HOST)
    unique_c = _constraint("K8sUniqueIngressHost", {})
    unique_c["spec"]["match"] = _join_match(
        "Ingress", ["networking.k8s.io"]
    )
    class_t = _template("K8sRequiredStorageClass", _JOIN_REQUIRED_CLASS)
    class_c = _constraint("K8sRequiredStorageClass", {})
    class_c["spec"]["match"] = _join_match(
        "PersistentVolumeClaim", ["*"]
    )
    quota_t = _template("K8sTeamQuota", _JOIN_TEAM_QUOTA)
    quota_c = _constraint("K8sTeamQuota", {"limit": 2})
    quota_c["spec"]["match"] = _join_match("Pod", [""])
    return [
        ("join-unique-host", unique_t, unique_c, unique_objs),
        ("join-required-class", class_t, class_c, class_objs),
        ("join-team-quota", quota_t, quota_c, quota_objs),
    ]
