"""Webhook tests (reference parity: pkg/webhook/policy_test.go +
namespacelabel_test.go scenarios, plus the HTTP server and micro-batcher).

The port's copy of tests/test_webhook.py: the same scenarios on
gatekeeper_tpu_torch, on the interpreter driver and on TorchDriver on the
CPU (its kernels' plain versions) where the JAX test builds TpuDriver."""

import json
import threading
import time
import urllib.request

import pytest

from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.metrics import Reporters
from gatekeeper_tpu_torch.metrics.views import Registry
from gatekeeper_tpu_torch.process.excluder import Excluder
from gatekeeper_tpu_torch.apis.config import MatchEntry
from gatekeeper_tpu_torch.webhook import (
    IGNORE_LABEL,
    MicroBatcher,
    NamespaceLabelHandler,
    ValidationHandler,
    WebhookServer,
)

from .test_torch_controllers import CONSTRAINT, TEMPLATE

NS_GVK = ("", "v1", "Namespace")


import pytest


@pytest.fixture(params=["interp", "torch-device"], autouse=True)
def _driver_mode(request):
    """Run the whole webhook suite twice: on the interpreter driver and
    with every review through TorchDriver's device path (it has no
    interpreter tier: every review evaluates there), proving webhook
    semantics on the kernels' path."""
    global _MODE
    _MODE = request.param
    yield
    _MODE = "interp"


_MODE = "interp"


def make_handler(**kw):
    if _MODE == "torch-device":
        from gatekeeper_tpu_torch.ops.driver import TorchDriver

        driver = TorchDriver(device="cpu")
        client = Client(driver=driver)
    else:
        client = Client()
    kube = InMemoryKube()
    handler = ValidationHandler(client, kube=kube, **kw)
    return handler, client, kube


def ns_request(name="demo", labels=None, user="alice", operation="CREATE"):
    obj = {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {"name": name, "labels": labels or {}},
    }
    return {
        "uid": "uid-1",
        "kind": {"group": "", "version": "v1", "kind": "Namespace"},
        "name": name,
        "namespace": "",
        "operation": operation,
        "userInfo": {"username": user},
        "object": obj,
    }


def pod_request(name="p", namespace="default", labels=None, operation="CREATE"):
    obj = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": labels or {}},
    }
    return {
        "uid": "uid-2",
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "name": name,
        "namespace": namespace,
        "operation": operation,
        "userInfo": {"username": "alice"},
        "object": obj,
    }


class TestValidationHandler:
    def test_gk_service_account_self_manage_bypass(self):
        handler, client, kube = make_handler()
        req = ns_request(
            user="system:serviceaccount:gatekeeper-system:gatekeeper-admin"
        )
        resp = handler.handle(req)
        assert resp.allowed
        assert "self-manage" in resp.message

    def test_delete_without_old_object_500(self):
        handler, client, kube = make_handler()
        req = ns_request(operation="DELETE")
        req["object"] = None
        req["oldObject"] = None
        resp = handler.handle(req)
        assert not resp.allowed and resp.code == 500

    def test_delete_uses_old_object(self):
        handler, client, kube = make_handler()
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        req = ns_request(operation="DELETE")
        req["oldObject"] = req.pop("object")
        resp = handler.handle(req)
        # old object has no gatekeeper label -> denied
        assert not resp.allowed and resp.code == 403

    def test_bad_template_is_user_error_422(self):
        handler, client, kube = make_handler()
        req = {
            "uid": "t",
            "kind": {"group": "templates.gatekeeper.sh", "version": "v1beta1",
                     "kind": "ConstraintTemplate"},
            "operation": "CREATE",
            "userInfo": {"username": "alice"},
            "object": {
                "apiVersion": "templates.gatekeeper.sh/v1beta1",
                "kind": "ConstraintTemplate",
                "metadata": {"name": "badtemplate"},
                "spec": {
                    "crd": {"spec": {"names": {"kind": "BadTemplate"}}},
                    "targets": [
                        {"target": "admission.k8s.gatekeeper.sh",
                         "rego": "not rego at all"}
                    ],
                },
            },
        }
        resp = handler.handle(req)
        assert not resp.allowed and resp.code == 422

    def test_good_template_allowed(self):
        handler, client, kube = make_handler()
        req = {
            "uid": "t",
            "kind": {"group": "templates.gatekeeper.sh", "version": "v1beta1",
                     "kind": "ConstraintTemplate"},
            "operation": "CREATE",
            "userInfo": {"username": "alice"},
            "object": TEMPLATE,
        }
        assert handler.handle(req).allowed

    def test_constraint_without_template_is_user_error(self):
        handler, client, kube = make_handler()
        req = {
            "uid": "c",
            "kind": {"group": "constraints.gatekeeper.sh", "version": "v1beta1",
                     "kind": "K8sRequiredLabels"},
            "operation": "CREATE",
            "userInfo": {"username": "alice"},
            "object": CONSTRAINT,
        }
        resp = handler.handle(req)
        assert not resp.allowed and resp.code == 422

    def test_bad_enforcement_action_500(self):
        handler, client, kube = make_handler()
        client.add_template(TEMPLATE)
        bad = json.loads(json.dumps(CONSTRAINT))
        bad["spec"]["enforcementAction"] = "everything-is-fine"
        req = {
            "uid": "c",
            "kind": {"group": "constraints.gatekeeper.sh", "version": "v1beta1",
                     "kind": "K8sRequiredLabels"},
            "operation": "CREATE",
            "userInfo": {"username": "alice"},
            "object": bad,
        }
        resp = handler.handle(req)
        assert not resp.allowed and resp.code == 500
        # validation disabled -> allowed
        handler.disable_enforcementaction_validation = True
        assert handler.handle(req).allowed

    def test_excluded_namespace_allowed(self):
        excluder = Excluder()
        excluder.add([MatchEntry(excluded_namespaces=["kube-system"],
                                 processes=["webhook"])])
        handler, client, kube = make_handler(excluder=excluder)
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        resp = handler.handle(pod_request(namespace="kube-system"))
        assert resp.allowed
        assert "ignored" in resp.message

    def test_deny_and_allow(self):
        handler, client, kube = make_handler()
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        resp = handler.handle(ns_request())
        assert not resp.allowed and resp.code == 403
        assert "[denied by ns-must-have-gk]" in resp.message
        ok = handler.handle(ns_request(labels={"gatekeeper": "yes"}))
        assert ok.allowed

    def test_dryrun_allows_but_reports(self):
        events = []
        handler, client, kube = make_handler(
            emit_admission_events=True, event_recorder=events.append
        )
        client.add_template(TEMPLATE)
        dry = json.loads(json.dumps(CONSTRAINT))
        dry["spec"]["enforcementAction"] = "dryrun"
        client.add_constraint(dry)
        resp = handler.handle(ns_request())
        assert resp.allowed
        assert len(events) == 1
        assert events[0]["reason"] == "DryrunViolation"

    def test_metrics_reported(self):
        reporter = Reporters(Registry())
        handler, client, kube = make_handler(reporter=reporter)
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        handler.handle(ns_request())
        handler.handle(ns_request(labels={"gatekeeper": "x"}))
        rows = reporter.registry.view_rows("request_count")
        assert rows[("deny",)] == 1
        assert rows[("allow",)] == 1

    def test_namespace_augmentation_missing_namespace_500(self):
        handler, client, kube = make_handler()
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        resp = handler.handle(pod_request(namespace="ghost"))
        assert not resp.allowed and resp.code == 500

    def test_namespace_kind_coercion_skips_ns_lookup(self):
        handler, client, kube = make_handler()
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        req = ns_request()
        # server-side apply sets namespace == name for Namespace objects;
        # coercion must clear it instead of failing the ns lookup
        req["namespace"] = "demo"
        resp = handler.handle(req)
        assert resp.code == 403  # evaluated, not errored

    def test_namespace_selector_uses_cluster_namespace(self):
        handler, client, kube = make_handler()
        client.add_template(TEMPLATE)
        kube.create({
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": "prod", "labels": {"env": "prod"}},
        })
        c = json.loads(json.dumps(CONSTRAINT))
        c["spec"]["match"] = {
            "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
            "namespaceSelector": {"matchLabels": {"env": "prod"}},
        }
        client.add_constraint(c)
        resp = handler.handle(pod_request(namespace="prod"))
        assert not resp.allowed  # matched via augmented namespace

    def test_trace_config(self, capsys):
        cfg = {
            "spec": {
                "validation": {
                    "traces": [
                        {"user": "alice",
                         "kind": {"group": "", "version": "v1",
                                  "kind": "Namespace"}}
                    ]
                }
            }
        }
        handler, client, kube = make_handler(injected_config=cfg)
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        trace, dump = handler._tracing_level(ns_request())
        assert trace and not dump
        trace, dump = handler._tracing_level(pod_request())
        assert not trace


class TestNamespaceLabelHandler:
    def test_delete_always_allowed(self):
        h = NamespaceLabelHandler()
        assert h.handle({"operation": "DELETE"}).allowed

    def test_non_namespace_allowed(self):
        h = NamespaceLabelHandler()
        resp = h.handle(pod_request(labels={IGNORE_LABEL: "1"}))
        assert resp.allowed and resp.message == "Not a namespace"

    def test_ignore_label_denied_for_non_exempt(self):
        h = NamespaceLabelHandler()
        resp = h.handle(ns_request(labels={IGNORE_LABEL: "1"}))
        assert not resp.allowed and resp.code == 403

    def test_exempt_namespace_allowed(self):
        h = NamespaceLabelHandler(exempt_namespaces=["demo"])
        resp = h.handle(ns_request(labels={IGNORE_LABEL: "1"}))
        assert resp.allowed

    def test_plain_namespace_allowed(self):
        h = NamespaceLabelHandler()
        assert h.handle(ns_request()).allowed


class TestMicroBatcher:
    def test_batches_concurrent_requests(self):
        client = Client()
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)

        calls = []
        orig = client.review_batch

        def counting_slow_batch(objs, tracing=False):
            # batching matters when evaluation is slow (a device dispatch
            # behind a network relay); with instant evals a concurrent
            # burst legitimately serializes through the idle fast path
            calls.append(len(objs))
            time.sleep(0.01)
            return orig(objs, tracing=tracing)

        client.review_batch = counting_slow_batch
        mb = MicroBatcher(client, window_s=0.05)
        try:
            results = [None] * 8
            reqs = [ns_request(name=f"ns-{i}") for i in range(8)]

            def call(i):
                from gatekeeper_tpu_torch.target.target import AugmentedReview
                results[i] = mb.review(AugmentedReview(admission_request=reqs[i]))

            threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert all(len(r.results()) == 1 for r in results)
            # coalesced: requests queued behind the in-flight evaluation
            # share dispatches — strictly fewer dispatches than requests
            assert sum(calls) == 8 and len(calls) < 8
        finally:
            mb.stop()

    def test_lone_request_pays_no_window(self):
        """Sparse traffic must not pay the batch window: an idle batcher
        dispatches a lone request immediately (the <=2ms p99 north star
        applies to the production server path, which includes this)."""
        client = Client()
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        window = 0.25  # absurdly large so a regression is unmissable
        mb = MicroBatcher(client, window_s=window)
        try:
            from gatekeeper_tpu_torch.target.target import AugmentedReview
            req = AugmentedReview(admission_request=ns_request(name="lone"))
            mb.review(req)  # settle: first call may race thread startup
            time.sleep(5 * window + 0.05)  # leave any burst state behind
            t0 = time.monotonic()
            out = mb.review(req)
            dur = time.monotonic() - t0
            assert len(out.results()) == 1
            assert dur < window / 2, (
                f"lone request took {dur*1000:.1f}ms — it waited the window"
            )
        finally:
            mb.stop()


class TestWebhookServer:
    def _post(self, port, path, request):
        body = json.dumps({
            "apiVersion": "admission.k8s.io/v1beta1",
            "kind": "AdmissionReview",
            "request": request,
        }).encode()
        r = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=body,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(r, timeout=10) as resp:
            return json.loads(resp.read())

    def test_end_to_end_admit(self):
        handler, client, kube = make_handler()
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        srv = WebhookServer(handler, port=0)
        srv.start()
        try:
            out = self._post(srv.port, "/v1/admit", ns_request())
            assert out["response"]["allowed"] is False
            assert out["response"]["status"]["code"] == 403
            assert out["response"]["uid"] == "uid-1"
            ok = self._post(srv.port, "/v1/admit",
                            ns_request(labels={"gatekeeper": "x"}))
            assert ok["response"]["allowed"] is True
        finally:
            srv.stop()

    def test_admitlabel_and_health(self):
        handler, client, kube = make_handler()
        srv = WebhookServer(
            handler, NamespaceLabelHandler(), port=0,
            readiness_check=lambda: False,
        )
        srv.start()
        try:
            out = self._post(srv.port, "/v1/admitlabel",
                             ns_request(labels={IGNORE_LABEL: "1"}))
            assert out["response"]["allowed"] is False
            with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5
            ) as r:
                assert r.status == 200
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/readyz", timeout=5
                )
                ready_code = 200
            except urllib.error.HTTPError as e:
                ready_code = e.code
            assert ready_code == 500
        finally:
            srv.stop()


class TestKeepAliveFraming:
    def test_404_with_body_does_not_poison_connection(self):
        """HTTP/1.1 keep-alive: early-return paths must drain the request
        body or the next request on the connection reads garbage."""
        import http.client
        handler, client, kube = make_handler()
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        srv = WebhookServer(handler, port=0)
        srv.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
            body = json.dumps({"request": ns_request()}).encode()
            conn.request("POST", "/wrong-path", body=body,
                         headers={"Content-Type": "application/json"})
            r1 = conn.getresponse()
            r1.read()
            assert r1.status == 404
            # the SAME connection must serve the next request cleanly
            conn.request("POST", "/v1/admit", body=body,
                         headers={"Content-Type": "application/json"})
            r2 = conn.getresponse()
            out = json.loads(r2.read())
            assert r2.status == 200
            assert out["response"]["allowed"] is False  # denied, not 400
        finally:
            srv.stop()

    def test_chunked_body_is_parsed(self):
        """A chunked POST must be decoded and evaluated exactly like a
        Content-Length one (Go's net/http does this in the transport);
        silently evaluating b"" would be a fail-open admission path."""
        import http.client
        handler, client, kube = make_handler()
        srv = WebhookServer(handler, port=0)
        srv.start()
        try:
            body = json.dumps({"request": ns_request()}).encode()
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
            conn.putrequest("POST", "/v1/admit")
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            # split the payload across two chunks
            mid = len(body) // 2
            for part in (body[:mid], body[mid:]):
                conn.send(("%x\r\n" % len(part)).encode() + part + b"\r\n")
            conn.send(b"0\r\n\r\n")
            r = conn.getresponse()
            out = json.loads(r.read())
            assert r.status == 200
            # same decision as the Content-Length path for this request
            conn.request("POST", "/v1/admit", body=body,
                         headers={"Content-Type": "application/json"})
            r2 = conn.getresponse()
            out2 = json.loads(r2.read())
            assert out["response"]["allowed"] == out2["response"]["allowed"]
        finally:
            srv.stop()

    def test_malformed_chunked_body_rejected(self):
        """Bad chunk framing must produce 400 + close — never an
        allowed=true evaluation of an empty body."""
        import http.client
        handler, client, kube = make_handler()
        srv = WebhookServer(handler, port=0)
        srv.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
            conn.putrequest("POST", "/v1/admit")
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            conn.send(b"ZZZ\r\nnot-a-size\r\n0\r\n\r\n")
            r = conn.getresponse()
            r.read()
            assert r.status == 400
            assert r.getheader("Connection") == "close"
        finally:
            srv.stop()

    def test_unknown_transfer_encoding_rejected(self):
        import http.client
        handler, client, kube = make_handler()
        srv = WebhookServer(handler, port=0)
        srv.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
            conn.putrequest("POST", "/v1/admit")
            conn.putheader("Transfer-Encoding", "gzip")
            conn.endheaders()
            r = conn.getresponse()
            r.read()
            assert r.status == 411
            assert r.getheader("Connection") == "close"
        finally:
            srv.stop()

    def test_stopped_server_refuses_keepalive_requests(self):
        """A persistent connection must not keep receiving admission
        decisions after stop() — handler threads outlive shutdown()."""
        import http.client
        handler, client, kube = make_handler()
        srv = WebhookServer(handler, port=0)
        srv.start()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        body = json.dumps({"request": ns_request()}).encode()
        conn.request("POST", "/v1/admit", body=body)
        assert conn.getresponse().read()  # connection established + served
        srv.stop()
        try:
            conn.request("POST", "/v1/admit", body=body)
            r = conn.getresponse()
            r.read()
            assert r.status == 503
        except (ConnectionError, http.client.HTTPException):
            pass  # the connection dropping outright is also a valid outcome


class TestFailurePolicyExactJSON:
    """Exact AdmissionReview JSON for internal errors and deadline
    exhaustion under fail-closed (default) and fail-open: the degraded
    webhook's wire contract is pinned byte-for-byte
    (docs/failure-modes.md)."""

    class _BoomClient:
        def __init__(self, exc):
            self.exc = exc

        def review(self, obj, tracing=False):
            raise self.exc

    def _admit(self, exc, fail_open):
        from gatekeeper_tpu_torch.kube.inmem import InMemoryKube as _Kube

        handler = ValidationHandler(
            self._BoomClient(exc), kube=_Kube(), fail_open=fail_open
        )
        srv = WebhookServer(handler, port=0)
        srv.start()
        try:
            body = json.dumps({
                "apiVersion": "admission.k8s.io/v1beta1",
                "kind": "AdmissionReview",
                "request": ns_request(),
            }).encode()
            r = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/admit", data=body,
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(r, timeout=10) as resp:
                return json.loads(resp.read())
        finally:
            srv.stop()

    def test_internal_error_fail_closed(self):
        out = self._admit(RuntimeError("boom"), fail_open=False)
        assert out == {
            "apiVersion": "admission.k8s.io/v1beta1",
            "kind": "AdmissionReview",
            "response": {
                "uid": "uid-1",
                "allowed": False,
                "status": {"message": "boom", "code": 500},
            },
        }

    def test_internal_error_fail_open(self):
        out = self._admit(RuntimeError("boom"), fail_open=True)
        assert out == {
            "apiVersion": "admission.k8s.io/v1beta1",
            "kind": "AdmissionReview",
            "response": {
                "uid": "uid-1",
                "allowed": True,
                "status": {"message": "boom", "code": 200},
                "auditAnnotations": {
                    "admission.gatekeeper.sh/fail-open": "internal-error"
                },
            },
        }

    def test_deadline_exhaustion_fail_closed(self):
        from gatekeeper_tpu_torch.deadline import DeadlineExceeded

        out = self._admit(DeadlineExceeded("late"), fail_open=False)
        assert out == {
            "apiVersion": "admission.k8s.io/v1beta1",
            "kind": "AdmissionReview",
            "response": {
                "uid": "uid-1",
                "allowed": False,
                "status": {
                    "message": "admission deadline budget exhausted",
                    "code": 504,
                },
            },
        }

    def test_deadline_exhaustion_fail_open(self):
        from gatekeeper_tpu_torch.deadline import DeadlineExceeded

        out = self._admit(DeadlineExceeded("late"), fail_open=True)
        assert out == {
            "apiVersion": "admission.k8s.io/v1beta1",
            "kind": "AdmissionReview",
            "response": {
                "uid": "uid-1",
                "allowed": True,
                "status": {
                    "message": "admission deadline budget exhausted",
                    "code": 200,
                },
                "auditAnnotations": {
                    "admission.gatekeeper.sh/fail-open": "deadline-exhausted"
                },
            },
        }


def test_missing_namespace_logged_without_traceback():
    """Namespace-not-synced is an expected operational condition: the 500
    verdict stands, logged as a WARNING with no exception traceback (at
    admission rates traceback formatting costs ~0.7ms/request,
    attacker-paced).  A handler is attached to the logger directly —
    caplog relies on propagation to root, which gklog.setup disables, so
    a caplog-based assertion would be order-dependent across the suite."""
    import logging as _logging

    records = []

    class _Capture(_logging.Handler):
        def emit(self, record):
            records.append(record)

    handler, client, kube = make_handler()
    client.add_template(TEMPLATE)
    client.add_constraint(CONSTRAINT)
    lg = _logging.getLogger("gatekeeper.webhook")
    cap = _Capture(level=_logging.DEBUG)
    lg.addHandler(cap)
    try:
        resp = handler.handle(pod_request(namespace="never-synced"))
    finally:
        lg.removeHandler(cap)
    assert not resp.allowed and resp.code == 500
    assert "never-synced" in resp.message
    recs = [r for r in records if "error executing query" in r.getMessage()]
    assert recs, records
    assert all(r.levelno == _logging.WARNING and r.exc_info is None
               for r in recs)
