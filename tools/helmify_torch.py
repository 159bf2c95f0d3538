#!/usr/bin/env python
"""Helm-chart generator for the port: deploy/gatekeeper-torch.yaml ->
charts/gatekeeper-tpu-torch/.

A copy of tools/helmify.py (tests/test_torch_copies.py names what
differs): the same split of the flattened manifest into one chart file
per (kind, name), CRDs into crds/, and the same deploy-time knobs
rewritten to `{{ .Values.* }}` references, over the port's manifest:
the image gatekeeper-tpu-torch, --driver=torch, one NVIDIA GPU a pod
(`gpuResource` / `gpuCount`, nvidia.com/gpu) on nodes the GPU operator
labels, and values.yaml's defaults extracted from that manifest, so the
chart and the raw manifest cannot drift.  tools/helmify.py and
charts/gatekeeper-tpu/ stay the JAX package's.

Run: python tools/helmify_torch.py   (idempotent; writes
charts/gatekeeper-tpu-torch).  Verified by tests/test_torch_helmify.py,
which regenerates and round-trips the chart against
deploy/gatekeeper-torch.yaml.
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO, "deploy", "gatekeeper-torch.yaml")
CHART = os.path.join(REPO, "charts", "gatekeeper-tpu-torch")

CHART_YAML = """\
apiVersion: v2
name: gatekeeper-tpu-torch
description: Gatekeeper-class policy controller on an NVIDIA GPU (PyTorch / CUDA port; vectorized audit + admission)
type: application
version: 3.1.0
appVersion: "3.1.0"
"""

HELPERS_TPL = """\
{{- define "gatekeeper-tpu.labels" -}}
app: gatekeeper-tpu
chart: {{ .Chart.Name }}
release: {{ .Release.Name }}
heritage: {{ .Release.Service }}
{{- end }}
"""

# deploy-time knobs: literal text in deploy/gatekeeper.yaml -> (values key,
# template expression).  The default value recorded in values.yaml is
# extracted from the manifest text, mirroring replacements.go's table.
# ORDER MATTERS: "containerPort: 8443" must rewrite before "port: 8443".
REPLACEMENTS = [
    ("image: gatekeeper-tpu-torch:latest",
     "image", "image: {{ .Values.image.repository }}:{{ .Values.image.tag }}"),
    ("imagePullPolicy: IfNotPresent",
     "image", "imagePullPolicy: {{ .Values.image.pullPolicy }}"),
    ("replicas: 3",
     "replicas", "replicas: {{ .Values.replicas }}"),
    ("- --log-level=INFO",
     "logLevel", "- --log-level={{ .Values.logLevel }}"),
    ("- --audit-chunk-size=0",
     "auditChunkSize",
     "- --audit-chunk-size={{ .Values.auditChunkSize }}"),
    # pod scheduling knobs (reference charts/gatekeeper/values.yaml:14-16):
    # the nodeSelector literal anchors the affinity/tolerations
    # conditionals, which are absent from the manifest (empty defaults)
    ("      nodeSelector:\n        kubernetes.io/os: linux\n"
     '        nvidia.com/gpu.present: "true"',
     "nodeSelector",
     "      nodeSelector:\n"
     "        {{- toYaml .Values.nodeSelector | nindent 8 }}\n"
     "      {{- if .Values.affinity }}\n"
     "      affinity:\n"
     "        {{- toYaml .Values.affinity | nindent 8 }}\n"
     "      {{- end }}\n"
     "      {{- if .Values.tolerations }}\n"
     "      tolerations:\n"
     "        {{- toYaml .Values.tolerations | nindent 8 }}\n"
     "      {{- end }}"),
    ("      annotations:\n"
     "        container.seccomp.security.alpha.kubernetes.io/manager: "
     "runtime/default",
     "podAnnotations",
     "      annotations:\n"
     "        {{- toYaml .Values.podAnnotations | nindent 8 }}"),
    ("          resources:\n"
     "            limits:\n"
     "              cpu: 1000m\n"
     "              memory: 512Mi\n"
     '              nvidia.com/gpu: "1"\n'
     "            requests:\n"
     "              cpu: 100m\n"
     "              memory: 256Mi",
     "resources",
     "          resources:\n"
     "            limits:\n"
     "              cpu: {{ .Values.resources.limits.cpu }}\n"
     "              memory: {{ .Values.resources.limits.memory }}\n"
     '              {{ .Values.gpuResource }}: "{{ .Values.gpuCount }}"\n'
     "            requests:\n"
     "              cpu: {{ .Values.resources.requests.cpu }}\n"
     "              memory: {{ .Values.resources.requests.memory }}"),
    ("- --audit-interval=60",
     "auditInterval", "- --audit-interval={{ .Values.auditInterval }}"),
    ("- --constraint-violations-limit=20",
     "constraintViolationsLimit",
     "- --constraint-violations-limit={{ .Values.constraintViolationsLimit }}"),
    ("- --driver=torch", "driver", "- --driver={{ .Values.driver }}"),
    ("- --port=8443", "webhookPort", "- --port={{ .Values.webhookPort }}"),
    ("containerPort: 8443",
     "webhookPort", "containerPort: {{ .Values.webhookPort }}"),
    ("port: 8443", "webhookPort", "port: {{ .Values.webhookPort }}"),
    ("containerPort: 8888",
     "prometheusPort", "containerPort: {{ .Values.prometheusPort }}"),
    # boolean flag present in the manifest -> gated on a value (default
    # matches the manifest: enabled)
    ("- --log-denies",
     "logDenies",
     "{{- if .Values.logDenies }}\n"
     "            - --log-denies\n"
     "            {{- end }}"),
    # repeatable flag -> range over a list value
    ("- --exempt-namespace=gatekeeper-system",
     "exemptNamespaces",
     "{{- range .Values.exemptNamespaces }}\n"
     "            - --exempt-namespace={{ . }}\n"
     "            {{- end }}"),
    # flags NOT in the manifest, exposed as off-by-default conditionals:
    # anchored on existing arg lines so the chart stays a pure derivation
    # of the manifest (at default values these render to the anchor alone)
    ("- --operation=webhook\n            - --operation=status",
     "emitAdmissionEvents",
     "- --operation=webhook\n"
     "            - --operation=status\n"
     "            {{- if .Values.emitAdmissionEvents }}\n"
     "            - --emit-admission-events\n"
     "            {{- end }}"),
    ("- --operation=audit\n            - --operation=status",
     "auditFromCache",
     "- --operation=audit\n"
     "            - --operation=status\n"
     "            {{- if .Values.auditFromCache }}\n"
     "            - --audit-from-cache\n"
     "            {{- end }}\n"
     "            {{- if .Values.emitAuditEvents }}\n"
     "            - --emit-audit-events\n"
     "            {{- end }}"),
]

# every key here is referenced by a template expression in REPLACEMENTS —
# a knob with no template reference would be silently discarded at install
VALUES_DEFAULTS = {
    "image": {
        "repository": "gatekeeper-tpu-torch",
        "tag": "latest",
        "pullPolicy": "IfNotPresent",
    },
    "replicas": 3,
    "auditInterval": 60,
    "constraintViolationsLimit": 20,
    "auditFromCache": False,
    "auditChunkSize": 0,
    "disableValidatingWebhook": False,
    "logLevel": "INFO",
    "driver": "torch",
    "webhookPort": 8443,
    "prometheusPort": 8888,
    "gpuResource": "nvidia.com/gpu",
    "gpuCount": 1,
    "logDenies": True,  # the deploy manifest enables it
    "exemptNamespaces": ["gatekeeper-system"],
    "emitAdmissionEvents": False,
    "emitAuditEvents": False,
    "nodeSelector": {"kubernetes.io/os": "linux",
                     "nvidia.com/gpu.present": "true"},
    "affinity": {},
    "tolerations": [],
    "podAnnotations": {
        "container.seccomp.security.alpha.kubernetes.io/manager":
            "runtime/default",
    },
    "resources": {
        "limits": {"cpu": "1000m", "memory": "512Mi"},
        "requests": {"cpu": "100m", "memory": "256Mi"},
    },
}

# README parameter table: every key of the upstream Gatekeeper chart's
# values surface that tools/helmify.py documents, plus the GPU knobs.
# tests/test_torch_helmify.py asserts the set is covered.
README_PARAMS = [
    ("auditInterval", "The frequency with which audit is run", "`60`"),
    ("constraintViolationsLimit",
     "The maximum # of audit violations reported on a constraint", "`20`"),
    ("auditFromCache",
     "Take the roster of resources to audit from the inventory cache",
     "`false`"),
    ("auditChunkSize",
     "Chunk size for listing cluster resources for audit", "`0`"),
    ("disableValidatingWebhook", "Disable ValidatingWebhook", "`false`"),
    ("emitAdmissionEvents",
     "Emit K8s events in gatekeeper namespace for admission violations",
     "`false`"),
    ("emitAuditEvents",
     "Emit K8s events in gatekeeper namespace for audit violations",
     "`false`"),
    ("logLevel", "Minimum log level", "`INFO`"),
    ("logDenies", "Log all denies (reference --log-denies flag)", "`true`"),
    ("image.pullPolicy", "The image pull policy", "`IfNotPresent`"),
    ("image.repository", "Image repository", "`gatekeeper-tpu-torch`"),
    ("image.tag", "The image tag to use", "`latest`"),
    ("resources", "The resource request/limits for the container image",
     "limits: 1 CPU, 512Mi, requests: 100m CPU, 256Mi"),
    ("nodeSelector", "The node selector to use for pod scheduling",
     "`kubernetes.io/os: linux`, `nvidia.com/gpu.present: \"true\"`"),
    ("affinity", "The node affinity to use for pod scheduling", "`{}`"),
    ("tolerations", "The tolerations to use for pod scheduling", "`[]`"),
    ("replicas", "The number of webhook replicas to deploy", "`3`"),
    ("podAnnotations", "The annotations to add to the pods",
     "`container.seccomp.security.alpha.kubernetes.io/manager: "
     "runtime/default`"),
    ("exemptNamespaces", "Namespaces exempted from admission",
     "`[gatekeeper-system]`"),
    ("driver", "Evaluation backend (`torch` or `interp`)", "`torch`"),
    ("webhookPort", "Webhook HTTPS port", "`8443`"),
    ("prometheusPort", "Prometheus metrics port", "`8888`"),
    ("gpuResource", "GPU resource name requested by the pods",
     "`nvidia.com/gpu`"),
    ("gpuCount", "GPUs per pod", "`1`"),
]


def render_readme() -> str:
    rows = "\n".join(
        f"| {k} | {d} | {v} |" for k, d, v in README_PARAMS
    )
    return f"""\
# gatekeeper-tpu-torch Helm Chart

Gatekeeper-class policy controller on an NVIDIA GPU: validating
admission webhook plus audit, evaluating constraints with the PyTorch /
CUDA port (`gatekeeper_tpu_torch`) and its hand-written kernels, baked
and sealed into the image (`Dockerfile.torch`).

## Install

```bash
make docker-build-torch      # the image gatekeeper-tpu-torch:latest
helm install gatekeeper-tpu-torch ./charts/gatekeeper-tpu-torch
```

The pods must not set `GK_SEAL_KEY` unless the image was built with the
same key (`make docker-build-torch SEAL_KEY_FILE=FILE`): the baked
kernels' seals would fail, and the pod has no `nvcc` to rebuild them.

## Parameters

| Parameter | Description | Default |
|:----------|:------------|:--------|
{rows}

## Contributing Changes

This chart is autogenerated from the static manifest
`deploy/gatekeeper-torch.yaml` by `tools/helmify_torch.py`.  Edit the
manifest and/or the generator and run `python tools/helmify_torch.py`
(`make manifests-torch`); `tests/test_torch_helmify.py` fails if the
committed chart drifts from the generator output.
"""

_KIND_RE = re.compile(r"^kind:\s+(\S+)\s*$", re.MULTILINE)
# exactly two spaces: metadata.name (helmify main.go:26-27)
_NAME_RE = re.compile(r"^  name:\s+(\S+)\s*$", re.MULTILINE)


def split_docs(text: str):
    docs = []
    for chunk in re.split(r"^---\s*$", text, flags=re.MULTILINE):
        chunk = chunk.strip("\n")
        if not chunk.strip() or all(
            line.strip().startswith("#") or not line.strip()
            for line in chunk.splitlines()
        ):
            continue
        docs.append(chunk)
    return docs


def doc_identity(doc: str):
    km = _KIND_RE.search(doc)
    nm = _NAME_RE.search(doc)
    if not km or not nm:
        raise ValueError(f"document without kind/name: {doc[:120]!r}")
    return km.group(1).strip("\"'"), nm.group(1).strip("\"'")


def template_doc(doc: str) -> str:
    for literal, _key, repl in REPLACEMENTS:
        doc = doc.replace(literal, repl)
    return doc


def render_values(values: dict, indent: int = 0) -> str:
    import json

    lines = []
    pad = "  " * indent
    for k, v in values.items():
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{k}:")
            lines.append(render_values(v, indent + 1))
        else:
            # empty dicts inline as {} — a dangling "key:" parses as null
            lines.append(f"{pad}{k}: {json.dumps(v)}")
    return "\n".join(lines)


def generate() -> dict:
    """Write the chart; returns {relative path: content}."""
    with open(MANIFEST) as f:
        manifest = f.read()
    out = {
        "Chart.yaml": CHART_YAML,
        "values.yaml": render_values(VALUES_DEFAULTS) + "\n",
        "README.md": render_readme(),
        "templates/_helpers.tpl": HELPERS_TPL,
    }
    for doc in split_docs(manifest):
        kind, name = doc_identity(doc)
        fname = f"{name}-{kind.lower()}.yaml"
        if kind == "CustomResourceDefinition":
            rel = f"crds/{fname}"  # Helm v3 crds dir (main.go:20)
            content = doc  # CRDs install as-is, never templated
        else:
            rel = f"templates/{fname}"
            content = template_doc(doc)
            if kind == "ValidatingWebhookConfiguration":
                # reference chart knob: the whole webhook registration
                # is omitted when disableValidatingWebhook=true
                content = (
                    "{{- if not .Values.disableValidatingWebhook }}\n"
                    + content.rstrip("\n")
                    + "\n{{- end }}"
                )
        out[rel] = content.rstrip("\n") + "\n"
    for rel, content in out.items():
        path = os.path.join(CHART, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(content)
    return out


def _to_yaml(v, indent: int) -> str:
    """Tiny toYaml: dicts/lists of scalars and nested dicts, at the
    given absolute indent (first line unindented; callers place it)."""
    import json

    pad = " " * indent
    if isinstance(v, dict):
        lines = []
        for k, val in v.items():
            if isinstance(val, (dict, list)) and val:
                lines.append(f"{pad}{k}:")
                lines.append(_to_yaml(val, indent + 2))
            else:
                lines.append(f"{pad}{k}: {json.dumps(val)}")
        return "\n".join(lines)
    if isinstance(v, list):
        lines = []
        for item in v:
            body = _to_yaml(item, indent + 2)
            lines.append(f"{pad}- {body[indent + 2:]}" if isinstance(
                item, (dict, list)) else f"{pad}- {json.dumps(item)}")
        return "\n".join(lines)
    return f"{pad}{json.dumps(v)}"


def _render_blocks(text: str, values: dict) -> str:
    """Evaluate the {{- if [not] .Values.x }} / {{- range .Values.x }} /
    {{- toYaml .Values.x | nindent N }} line blocks this generator emits
    (non-nested)."""
    out = []
    lines = text.splitlines()
    i = 0
    end_re = re.compile(r"\s*\{\{- end \}\}\s*$")
    if_re = re.compile(r"\s*\{\{- if (not )?\.Values\.(\w+) \}\}\s*$")
    range_re = re.compile(r"\s*\{\{- range \.Values\.(\w+) \}\}\s*$")
    toyaml_re = re.compile(
        r"\s*\{\{- toYaml \.Values\.(\w+) \| nindent (\d+) \}\}\s*$"
    )
    while i < len(lines):
        m_if = if_re.match(lines[i])
        m_rg = range_re.match(lines[i])
        m_ty = toyaml_re.match(lines[i])
        if m_ty:
            v = values.get(m_ty.group(1))
            if v:
                out.append(_to_yaml(v, int(m_ty.group(2))))
            i += 1
            continue
        if m_if or m_rg:
            body = []
            i += 1
            while not end_re.match(lines[i]):
                body.append(lines[i])
                i += 1
            i += 1  # the {{- end }} line
            if m_if:
                truthy = bool(values.get(m_if.group(2)))
                if truthy != bool(m_if.group(1)):  # group(1): "not "
                    # recurse: toYaml lines may sit inside an if body
                    out.extend(
                        _render_blocks("\n".join(body), values).splitlines()
                    )
            else:
                for item in values.get(m_rg.group(1), ()):
                    out.extend(b.replace("{{ . }}", str(item)) for b in body)
            continue
        out.append(lines[i])
        i += 1
    return "\n".join(out)


def render_chart(values: dict) -> str:
    """Minimal chart renderer (no helm binary in this image): evaluates the
    if/range blocks and {{ .Values.* }} expressions this generator emits.
    Used by the round-trip test to prove chart == manifest at default
    values."""
    rendered = []
    for rel in sorted(os.listdir(os.path.join(CHART, "crds"))):
        with open(os.path.join(CHART, "crds", rel)) as f:
            rendered.append(f.read().rstrip("\n"))
    tpl_dir = os.path.join(CHART, "templates")
    for rel in sorted(os.listdir(tpl_dir)):
        if rel.startswith("_"):
            continue
        with open(os.path.join(tpl_dir, rel)) as f:
            text = _render_blocks(f.read(), values)

        def sub(m):
            cur = values
            for part in m.group(1).split(".")[2:]:
                cur = cur[part]
            return str(cur).lower() if isinstance(cur, bool) else str(cur)

        text = re.sub(r"\{\{ (\.Values[.\w]+) \}\}", sub, text)
        rendered.append(text.rstrip("\n"))
    return "\n---\n".join(rendered) + "\n"


if __name__ == "__main__":
    files = generate()
    print(f"wrote {len(files)} chart files to {CHART}", file=sys.stderr)
