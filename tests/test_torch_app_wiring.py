"""Full-process integration: App wiring (reference main.go setup order),
driving the whole stack through the API store exactly as a cluster would.

The port's copy of tests/test_app.py: the same scenarios on
gatekeeper_tpu_torch's App, with --driver interp and with --driver torch
on the CPU (--torch-device cpu)."""

import json
import ssl
import time
import urllib.request

import pytest

from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.main import App, build_parser

from .test_torch_controllers import CONSTRAINT, TEMPLATE

CGVK = ("constraints.gatekeeper.sh", "v1beta1", "K8sRequiredLabels")


DRIVER_FLAGS = {
    "interp": ["--driver", "interp"],
    "torch-device": ["--driver", "torch", "--torch-device", "cpu"],
}


@pytest.fixture(params=sorted(DRIVER_FLAGS), autouse=True)
def _driver_mode(request, tmp_path):
    """Run the suite twice: on the interpreter driver and on TorchDriver
    on the CPU (the kernels' plain versions).  Each test's Apps write
    their TLS files into its own directory, so that no two Apps (of this
    run or another) pair one's certificate with another's key."""
    global _MODE, _CERT_DIR
    _MODE, _CERT_DIR = request.param, str(tmp_path / "certs")
    yield
    _MODE, _CERT_DIR = "interp", None


_MODE = "interp"
_CERT_DIR = None


def make_app(extra_flags=None, kube=None):
    flags = DRIVER_FLAGS[_MODE] + [
        "--port", "0",
        "--prometheus-port", "0",
        "--health-addr", ":0",
        "--audit-interval", "0.1",
        "--cert-dir", _CERT_DIR,
    ] + (extra_flags or [])
    return App(build_parser().parse_args(flags), kube=kube)


def _scheme_ctx(app):
    """(scheme, ssl_context) for talking to the app's webhook: TLS when
    cert rotation is live, plain HTTP where the `cryptography` package is
    unavailable and App degraded with its explicit warning."""
    if app.rotator is None:
        return "http", None
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return "https", ctx


def _post_admit(app, request):
    body = json.dumps({"request": request}).encode()
    scheme, ctx = _scheme_ctx(app)
    r = urllib.request.Request(
        f"{scheme}://127.0.0.1:{app.webhook_server.port}/v1/admit", data=body
    )
    with urllib.request.urlopen(r, context=ctx, timeout=10) as resp:
        return json.loads(resp.read())


class TestApp:
    def test_full_stack(self):
        kube = InMemoryKube()
        app = make_app(kube=kube)
        app.start()
        try:
            # template + constraint arrive via the API store, ingested by
            # the controllers
            kube.create(json.loads(json.dumps(TEMPLATE)))
            assert app.manager.drain()
            kube.create(json.loads(json.dumps(CONSTRAINT)))
            assert app.manager.drain()
            assert app.client.templates() == ["K8sRequiredLabels"]

            # webhook over TLS denies a bad namespace
            out = _post_admit(app, {
                "uid": "u1",
                "kind": {"group": "", "version": "v1", "kind": "Namespace"},
                "name": "bad-ns", "namespace": "",
                "operation": "CREATE",
                "userInfo": {"username": "alice"},
                "object": {"apiVersion": "v1", "kind": "Namespace",
                           "metadata": {"name": "bad-ns", "labels": {}}},
            })
            assert out["response"]["allowed"] is False

            # audit loop writes status violations
            kube.create({"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": "unlabeled"}})
            deadline = time.monotonic() + 10
            st = {}
            while time.monotonic() < deadline:
                st = kube.get(CGVK, "ns-must-have-gk").get("status") or {}
                if st.get("violations"):
                    break
                time.sleep(0.05)
            assert any(v["name"] == "unlabeled" for v in st["violations"])

            # metrics endpoint live
            with urllib.request.urlopen(
                f"http://127.0.0.1:{app.metrics_exporter.port}/metrics",
                timeout=5,
            ) as r:
                text = r.read().decode()
            assert "gatekeeper_request_count" in text
            assert "gatekeeper_audit_duration_seconds" in text

            # readiness
            assert app.tracker.wait_satisfied(timeout=5)
            scheme, ctx = _scheme_ctx(app)
            with urllib.request.urlopen(
                urllib.request.Request(
                    f"{scheme}://127.0.0.1:{app.webhook_server.port}/readyz"
                ),
                context=ctx,
                timeout=5,
            ) as r:
                assert r.status == 200
        finally:
            app.stop()

    def test_audit_only_role(self):
        kube = InMemoryKube()
        app = make_app(extra_flags=["--operation", "audit"], kube=kube)
        app.start()
        try:
            assert app.webhook_server is None
            assert app.audit_manager is not None
            assert app.health_server is not None
            with urllib.request.urlopen(
                f"http://127.0.0.1:{app.health_server.port}/healthz",
                timeout=5,
            ) as r:
                assert r.status == 200
        finally:
            app.stop()

    def test_upgrade_runs_before_controllers(self):
        kube = InMemoryKube()
        old = json.loads(json.dumps(TEMPLATE))
        old["apiVersion"] = "templates.gatekeeper.sh/v1alpha1"
        kube.create(old)
        app = make_app(kube=kube)
        app.start()
        try:
            assert app.manager.drain()
            # migrated to v1beta1 and ingested
            assert app.client.templates() == ["K8sRequiredLabels"]
        finally:
            app.stop()
