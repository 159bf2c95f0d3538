"""The port's chart generator, tools/helmify_torch.py (a copy of
tools/helmify.py over deploy/gatekeeper-torch.yaml): tests/test_helmify.py's
cases over charts/gatekeeper-tpu-torch/ — the committed chart is what the
generator writes, every manifest document lands in it, the chart rendered
at its defaults equals the manifest, and every knob is substituted and
takes effect (the GPU's ``gpuResource`` / ``gpuCount`` in place of the
TPU's)."""

import os
import sys

import yaml

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import helmify_torch as helmify  # noqa: E402


def test_generated_chart_matches_checked_in_chart(tmp_path, monkeypatch):
    """Regenerating into a scratch dir must produce byte-identical files to
    the committed chart — i.e. the committed chart is up to date."""
    monkeypatch.setattr(helmify, "CHART", str(tmp_path))
    files = helmify.generate()
    chart_dir = os.path.join(os.path.dirname(__file__), "..",
                             "charts", "gatekeeper-tpu-torch")
    for rel, content in files.items():
        committed = os.path.join(chart_dir, rel)
        assert os.path.exists(committed), f"missing committed chart file {rel}"
        with open(committed) as f:
            assert f.read() == content, f"stale committed chart file {rel}"


def test_every_manifest_doc_lands_in_chart():
    with open(helmify.MANIFEST) as f:
        docs = helmify.split_docs(f.read())
    identities = {helmify.doc_identity(d) for d in docs}
    assert len(identities) == len(docs), "duplicate kind/name in manifest"
    chart_files = []
    for sub in ("crds", "templates"):
        chart_files += [f for f in os.listdir(os.path.join(helmify.CHART, sub))
                        if not f.startswith("_")]
    assert len(chart_files) == len(docs)
    crds = [k for k, _ in identities if k == "CustomResourceDefinition"]
    assert len(os.listdir(os.path.join(helmify.CHART, "crds"))) == len(crds)


def test_rendered_chart_roundtrips_to_manifest_semantics():
    """Rendering the chart at default values must yield the same parsed
    objects as deploy/gatekeeper-torch.yaml (order-independent)."""
    rendered = helmify.render_chart(helmify.VALUES_DEFAULTS)
    with open(helmify.MANIFEST) as f:
        manifest = f.read()

    def objset(text):
        out = {}
        for d in yaml.safe_load_all(text):
            if d:
                out[(d["kind"], d["metadata"]["name"])] = d
        return out

    got, want = objset(rendered), objset(manifest)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], f"chart drift for {key}"


def test_values_are_substituted_not_hardcoded():
    dep = os.path.join(helmify.CHART, "templates",
                       "gatekeeper-audit-deployment.yaml")
    with open(dep) as f:
        text = f.read()
    assert "{{ .Values.auditInterval }}" in text
    assert "{{ .Values.constraintViolationsLimit }}" in text
    assert "{{ .Values.image.repository }}" in text
    assert '{{ .Values.gpuResource }}: "{{ .Values.gpuCount }}"' in text
    assert "{{ .Values.driver }}" in text
    cm = os.path.join(helmify.CHART, "templates",
                      "gatekeeper-controller-manager-deployment.yaml")
    with open(cm) as f:
        assert "{{ .Values.replicas }}" in f.read()


def test_non_default_values_take_effect():
    """Every exposed knob must actually change the rendered output
    (a values key with no template reference would be silently ignored)."""
    vals = dict(helmify.VALUES_DEFAULTS)
    vals.update(logDenies=False, emitAuditEvents=True, auditFromCache=True,
                gpuResource="nvidia.com/mig-3g.40gb", gpuCount=2,
                exemptNamespaces=["a", "b"], webhookPort=9443,
                driver="interp", prometheusPort=9999,
                logLevel="DEBUG", auditChunkSize=500,
                image={"repository": "gatekeeper-tpu-torch", "tag": "latest",
                       "pullPolicy": "Always"},
                nodeSelector={"pool": "gpu"},
                affinity={"nodeAffinity": {"weight": 1}},
                tolerations=[{"key": "nvidia.com/gpu",
                              "operator": "Exists"}],
                podAnnotations={"a/b": "c"},
                resources={"limits": {"cpu": "2000m", "memory": "1Gi"},
                           "requests": {"cpu": "500m", "memory": "512Mi"}})
    text = helmify.render_chart(vals)
    docs = {(d["kind"], d["metadata"]["name"]): d
            for d in yaml.safe_load_all(text) if d}
    cm = docs[("Deployment", "gatekeeper-controller-manager")]
    tspec = cm["spec"]["template"]["spec"]
    spec = tspec["containers"][0]
    assert "--log-denies" not in spec["args"]
    assert "--exempt-namespace=a" in spec["args"]
    assert "--exempt-namespace=b" in spec["args"]
    assert "--driver=interp" in spec["args"]
    assert "--port=9443" in spec["args"]
    assert "--log-level=DEBUG" in spec["args"]
    assert spec["imagePullPolicy"] == "Always"
    ports = {p.get("name"): p["containerPort"] for p in spec["ports"]}
    assert ports["webhook"] == 9443 and ports["metrics"] == 9999
    assert tspec["nodeSelector"] == {"pool": "gpu"}
    assert tspec["affinity"] == {"nodeAffinity": {"weight": 1}}
    assert tspec["tolerations"] == [{"key": "nvidia.com/gpu",
                                     "operator": "Exists"}]
    annotations = cm["spec"]["template"]["metadata"]["annotations"]
    assert annotations == {"a/b": "c"}
    aud = docs[("Deployment", "gatekeeper-audit")]
    aspec = aud["spec"]["template"]["spec"]["containers"][0]
    assert "--audit-from-cache" in aspec["args"]
    assert "--emit-audit-events" in aspec["args"]
    assert "--audit-chunk-size=500" in aspec["args"]
    assert aspec["resources"]["limits"] == {
        "cpu": "2000m", "memory": "1Gi", "nvidia.com/mig-3g.40gb": "2"}
    assert aspec["resources"]["requests"] == {
        "cpu": "500m", "memory": "512Mi"}


def test_disable_validating_webhook_removes_registration():
    vals = dict(helmify.VALUES_DEFAULTS, disableValidatingWebhook=True)
    docs = {(d["kind"], d["metadata"]["name"])
            for d in yaml.safe_load_all(helmify.render_chart(vals)) if d}
    assert not any(k == "ValidatingWebhookConfiguration" for k, _ in docs)
    # and present at defaults
    docs0 = {(d["kind"], d["metadata"]["name"]) for d in yaml.safe_load_all(
        helmify.render_chart(helmify.VALUES_DEFAULTS)) if d}
    assert any(k == "ValidatingWebhookConfiguration" for k, _ in docs0)


def test_reference_values_surface_is_covered():
    """Every key of the upstream Gatekeeper chart's values surface that
    tests/test_helmify.py holds the JAX chart to exists in this chart's
    values (image.release is named image.tag here) and is documented in
    the chart README, with the GPU knobs beside them."""
    ref_keys = {
        "replicas", "auditInterval", "constraintViolationsLimit",
        "auditFromCache", "disableValidatingWebhook", "auditChunkSize",
        "logLevel", "emitAdmissionEvents", "emitAuditEvents",
        "nodeSelector", "affinity", "tolerations", "podAnnotations",
        "resources",
    }
    missing = (ref_keys | {"gpuResource", "gpuCount"}) - set(
        helmify.VALUES_DEFAULTS)
    assert not missing, f"values keys not exposed: {missing}"
    assert not {"tpuResource", "tpuCount"} & set(helmify.VALUES_DEFAULTS)
    for sub in ("repository", "pullPolicy", "tag"):  # image.release -> tag
        assert sub in helmify.VALUES_DEFAULTS["image"]
    readme = os.path.join(helmify.CHART, "README.md")
    with open(readme) as f:
        text = f.read()
    documented = {k for k, _, _ in helmify.README_PARAMS}
    undocumented = (ref_keys | {"image.pullPolicy", "gpuResource",
                                "gpuCount"}) - documented
    assert not undocumented, f"README missing params: {undocumented}"
    for k, _, _ in helmify.README_PARAMS:
        assert k in text
    assert "GK_SEAL_KEY" in text


def test_the_jax_chart_is_untouched_by_the_ports():
    import helmify as jax_helmify

    assert jax_helmify.CHART != helmify.CHART
    assert jax_helmify.MANIFEST != helmify.MANIFEST
    assert jax_helmify.VALUES_DEFAULTS["driver"] == "tpu"
    assert helmify.VALUES_DEFAULTS["driver"] == "torch"
