"""The port's wire path: gatekeeper_tpu_torch's HTTP Kubernetes client
(kube/http_client.py) against its envtest stand-in (kube/apiserver.py),
as tests/test_http_kube.py holds the JAX package's: discovery, CRD
establishment, resourceVersion conflicts, the status subresource,
pagination, streaming watch with resume and 410 relist, bearer tokens and
TLS.  Then the process over the wire: gatekeeper_tpu_torch.main.App with
--driver torch --torch-device cpu against the API server, alone and split
into a webhook pod and an audit pod; the port's AuditManager streaming
its audit in continue-token pages (tests/test_audit_streaming.py's wire
tests) and riding out a full API-server outage (tests/test_chaos.py's
TestAuditOutage), its evaluations through TorchDriver(device="cpu").
Without a card, an App over the wire with --driver torch on the default
device fails at construction, as it does over the in-memory store.
"""

import json
import pathlib
import ssl
import time
import urllib.request

import pytest
import torch
import yaml

# the HTTPS kube stub serves real TLS; without `cryptography` the cert
# helpers cannot import — skip cleanly instead of erroring at collection
pytest.importorskip("cryptography")

from gatekeeper_tpu_torch import faults
from gatekeeper_tpu_torch.audit import AuditManager
from gatekeeper_tpu_torch.certs.rotator import (
    generate_ca,
    generate_server_cert,
)
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.faults import FaultRule
from gatekeeper_tpu_torch.kube.apiserver import KubeApiServer
from gatekeeper_tpu_torch.kube.http_client import HttpKube, KubeError
from gatekeeper_tpu_torch.kube.inmem import Conflict, NotFound
from gatekeeper_tpu_torch.metrics import Reporters
from gatekeeper_tpu_torch.metrics.views import Registry
from gatekeeper_tpu_torch.ops.driver import TorchDriver

from .test_torch_controllers import CONSTRAINT, TEMPLATE

NS_GVK = ("", "v1", "Namespace")
POD_GVK = ("", "v1", "Pod")
CRD_GVK = ("apiextensions.k8s.io", "v1", "CustomResourceDefinition")
WIDGET_GVK = ("acme.example.com", "v1", "Widget")
TEMPLATES_GVK = ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
CGVK = ("constraints.gatekeeper.sh", "v1beta1", "K8sRequiredLabels")

WIDGET_CRD = {
    "apiVersion": "apiextensions.k8s.io/v1",
    "kind": "CustomResourceDefinition",
    "metadata": {"name": "widgets.acme.example.com"},
    "spec": {
        "group": "acme.example.com",
        "names": {"kind": "Widget", "plural": "widgets"},
        "scope": "Namespaced",
        "versions": [
            {"name": "v1", "served": True, "storage": True,
             "subresources": {"status": {}}},
        ],
    },
}


def load_deploy_crds():
    manifest = pathlib.Path(__file__).parent.parent / "deploy/gatekeeper.yaml"
    with open(manifest) as f:
        return [d for d in yaml.safe_load_all(f)
                if d and d.get("kind") == "CustomResourceDefinition"]


@pytest.fixture()
def server():
    srv = KubeApiServer()
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def client(server):
    return HttpKube(server.url, discovery_retry_s=1.0)


def ns(name, labels=None):
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name, "labels": labels or {}}}


def pod(name, namespace="default"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {"containers": []}}


class TestCRUD:
    def test_create_get_list_delete(self, client):
        created = client.create(ns("alpha", {"team": "a"}))
        assert created["metadata"]["resourceVersion"]
        got = client.get(NS_GVK, "alpha")
        assert got["metadata"]["labels"] == {"team": "a"}
        client.create(ns("beta"))
        names = [o["metadata"]["name"] for o in client.list(NS_GVK)]
        assert names == ["alpha", "beta"]
        assert client.delete(NS_GVK, "alpha") is True
        assert client.delete(NS_GVK, "alpha") is False
        with pytest.raises(NotFound):
            client.get(NS_GVK, "alpha")

    def test_create_conflict(self, client):
        client.create(ns("dup"))
        with pytest.raises(Conflict):
            client.create(ns("dup"))

    def test_namespaced_routes(self, client):
        client.create(pod("p1", "default"))
        client.create(pod("p1", "other"))
        assert len(client.list(POD_GVK)) == 2
        assert len(client.list(POD_GVK, namespace="other")) == 1
        assert client.get(POD_GVK, "p1", "other")["metadata"][
            "namespace"] == "other"
        client.delete(POD_GVK, "p1", "default")
        assert len(client.list(POD_GVK)) == 1

    def test_update_conflict_semantics(self, client):
        created = client.create(ns("upd"))
        stale = json.loads(json.dumps(created))
        created["metadata"]["labels"] = {"x": "1"}
        client.update(created, check_version=True)
        stale["metadata"]["labels"] = {"x": "2"}
        with pytest.raises(Conflict):
            client.update(stale, check_version=True)
        # last-write-wins path strips the RV
        client.update(stale, check_version=False)
        assert client.get(NS_GVK, "upd")["metadata"]["labels"] == {"x": "2"}

    def test_apply_create_or_update(self, client):
        client.apply(ns("ap", {"v": "1"}))
        client.apply(ns("ap", {"v": "2"}))
        assert client.get(NS_GVK, "ap")["metadata"]["labels"] == {"v": "2"}

    def test_pagination(self, client):
        for i in range(7):
            client.create(pod(f"pg-{i}"))
        assert len(client.list(POD_GVK, limit=3)) == 7

    def test_pagination_consistent_under_churn(self, server, client):
        """Continue tokens serve the snapshot taken at page 1 — a delete
        between pages cannot shift later pages (the real apiserver's
        consistent-list contract the audit chunking relies on)."""
        for i in range(6):
            client.create(pod(f"ch-{i:02d}"))
        path = client._path(POD_GVK, "default")
        status, doc = client._request("GET", path + "?limit=2")
        assert status == 200
        token = doc["metadata"]["continue"]
        client.delete(POD_GVK, "ch-00", "default")  # churn between pages
        got = [o["metadata"]["name"] for o in doc["items"]]
        while token:
            status, doc = client._request(
                "GET", path + f"?limit=2&continue={token}")
            assert status == 200
            got += [o["metadata"]["name"] for o in doc["items"]]
            token = doc["metadata"].get("continue", "")
        assert got == [f"ch-{i:02d}" for i in range(6)]  # nothing skipped

    def test_unknown_kind_fails_fast_after_first_miss(self, client):
        t0 = time.monotonic()
        with pytest.raises(NotFound):
            client.get(("nope.example.com", "v1", "Nope"), "x")
        first = time.monotonic() - t0
        assert first >= 1.0  # establishment wait
        t0 = time.monotonic()
        with pytest.raises(NotFound):
            client.get(("nope.example.com", "v1", "Nope"), "x")
        assert time.monotonic() - t0 < 0.2  # negative cache


class TestDiscoveryAndCRDs:
    def test_crd_establishment_and_cr_crud(self, server, client):
        client.create(WIDGET_CRD)
        crd = client.get(CRD_GVK, "widgets.acme.example.com")
        conds = {c["type"]: c["status"]
                 for c in crd.get("status", {}).get("conditions", [])}
        assert conds.get("Established") == "True"
        w = {"apiVersion": "acme.example.com/v1", "kind": "Widget",
             "metadata": {"name": "w1", "namespace": "default"},
             "spec": {"size": 3}}
        client.create(w)
        assert client.get(WIDGET_GVK, "w1", "default")["spec"]["size"] == 3
        assert WIDGET_GVK in client.list_gvks()

    def test_delayed_establishment(self):
        srv = KubeApiServer(establish_delay_s=0.5)
        srv.start()
        try:
            c = HttpKube(srv.url, discovery_retry_s=3.0)
            c.create(WIDGET_CRD)
            # immediately usable thanks to the client's establishment wait
            c.create({"apiVersion": "acme.example.com/v1", "kind": "Widget",
                      "metadata": {"name": "w1", "namespace": "default"}})
            assert c.get(WIDGET_GVK, "w1", "default")
        finally:
            srv.stop()

    def test_status_subresource_semantics(self, client):
        client.create(WIDGET_CRD)
        w = {"apiVersion": "acme.example.com/v1", "kind": "Widget",
             "metadata": {"name": "w2", "namespace": "default"},
             "spec": {"size": 1}, "status": {"phase": "sneaky"}}
        created = client.create(w)
        # status dropped on create
        assert "status" not in created or not created.get("status")
        # status write goes via the subresource
        created["status"] = {"phase": "Ready"}
        client.update(created, check_version=True, subresource="status")
        cur = client.get(WIDGET_GVK, "w2", "default")
        assert cur["status"] == {"phase": "Ready"}
        # a spec PUT cannot clobber status
        cur["spec"] = {"size": 9}
        cur["status"] = {"phase": "Clobbered"}
        client.update(cur, check_version=True)
        cur = client.get(WIDGET_GVK, "w2", "default")
        assert cur["spec"] == {"size": 9}
        assert cur["status"] == {"phase": "Ready"}


class TestWatch:
    def test_replay_and_live_events(self, client):
        client.create(ns("w-a"))
        w = client.watch(NS_GVK, replay=True)
        try:
            ev = w.next(timeout=5)
            assert ev.type == "ADDED"
            assert ev.object["metadata"]["name"] == "w-a"
            client.create(ns("w-b"))
            ev = w.next(timeout=5)
            assert (ev.type, ev.object["metadata"]["name"]) == (
                "ADDED", "w-b")
            obj = client.get(NS_GVK, "w-b")
            obj["metadata"]["labels"] = {"mod": "1"}
            client.update(obj, check_version=True)
            ev = w.next(timeout=5)
            assert ev.type == "MODIFIED"
            client.delete(NS_GVK, "w-b")
            ev = w.next(timeout=5)
            assert ev.type == "DELETED"
        finally:
            w.stop()

    def test_resume_after_disconnect(self, server, client):
        w = client.watch(NS_GVK, replay=False)
        try:
            client.create(ns("r-1"))
            assert w.next(timeout=5).object["metadata"]["name"] == "r-1"
            server.kill_watches()  # force the stream down
            time.sleep(0.1)
            client.create(ns("r-2"))  # lands while the watcher reconnects
            ev = w.next(timeout=5)
            assert ev is not None and ev.object["metadata"][
                "name"] == "r-2"
        finally:
            w.stop()

    def test_gone_triggers_relist(self):
        srv = KubeApiServer(watch_history=4)
        srv.start()
        try:
            c = HttpKube(srv.url, discovery_retry_s=1.0)
            c.create(ns("g-keep"))
            w = c.watch(NS_GVK, replay=False)
            try:
                # take the stream down, then push the retained window past
                # the watcher's resume point
                srv.kill_watches()
                c.create(ns("g-new"))
                c.delete(NS_GVK, "g-keep")
                for i in range(8):
                    c.create(ns(f"g-flood-{i}"))
                    c.delete(NS_GVK, f"g-flood-{i}")
                # the relist path must synthesize ADDED g-new + DELETED
                # g-keep (order not guaranteed)
                seen = {}
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and len(seen) < 2:
                    ev = w.next(timeout=0.5)
                    if ev is None:
                        continue
                    name = ev.object["metadata"]["name"]
                    if name in ("g-new", "g-keep"):
                        seen[name] = ev.type
                assert seen.get("g-new") == "ADDED"
                assert seen.get("g-keep") == "DELETED"
            finally:
                w.stop()
        finally:
            srv.stop()


class TestAuthAndTLS:
    def test_bearer_token(self):
        srv = KubeApiServer(token="sekrit")
        srv.start()
        try:
            bad = HttpKube(srv.url, token="wrong", discovery_retry_s=0.3)
            with pytest.raises((KubeError, NotFound)):
                bad.create(ns("x"))
            good = HttpKube(srv.url, token="sekrit",
                            discovery_retry_s=1.0)
            good.create(ns("x"))
            assert good.get(NS_GVK, "x")
        finally:
            srv.stop()

    def test_tls_with_verified_ca(self, tmp_path):
        ca_pem, ca_key = generate_ca()
        crt, key = generate_server_cert(ca_pem, ca_key, ["localhost"])
        certfile = tmp_path / "tls.crt"
        keyfile = tmp_path / "tls.key"
        certfile.write_bytes(crt)
        keyfile.write_bytes(key)
        srv = KubeApiServer(tls=(str(certfile), str(keyfile)))
        srv.start()
        try:
            c = HttpKube(f"https://localhost:{srv.port}", ca_data=ca_pem,
                         discovery_retry_s=1.0)
            c.create(ns("tls-ok"))
            assert c.get(NS_GVK, "tls-ok")
        finally:
            srv.stop()


class TestFullStackOverHTTP:
    """The App — controllers, webhook, audit, readiness — running against
    the API server purely over the wire, as in a cluster."""

    def test_end_to_end(self, tmp_path):
        srv = KubeApiServer()
        srv.start()
        try:
            admin = HttpKube(srv.url, discovery_retry_s=2.0)
            for crd in load_deploy_crds():
                admin.create(crd)
            admin.create(ns("gatekeeper-system"))

            from gatekeeper_tpu_torch.main import App, build_parser

            app_kube = HttpKube(srv.url, discovery_retry_s=2.0)
            flags = [
                "--driver", "torch", "--torch-device", "cpu",
                "--port", "0",
                "--prometheus-port", "0",
                "--health-addr", ":0",
                "--audit-interval", "0.1",
                "--cert-dir", str(tmp_path / "certs"),
            ]
            app = App(build_parser().parse_args(flags), kube=app_kube)
            app.start()
            try:
                admin.create(json.loads(json.dumps(TEMPLATE)))
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline:
                    if app.client.templates() == ["K8sRequiredLabels"]:
                        break
                    time.sleep(0.05)
                assert app.client.templates() == ["K8sRequiredLabels"]

                # template controller synthesized + created the constraint
                # CRD over HTTP; the constraint kind is now served
                admin.create(json.loads(json.dumps(CONSTRAINT)))
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline:
                    if app.client.get_constraint("K8sRequiredLabels",
                                                 "ns-must-have-gk"):
                        break
                    time.sleep(0.05)
                assert app.client.get_constraint("K8sRequiredLabels",
                                                 "ns-must-have-gk")

                # admission over TLS: the webhook denies a bad namespace
                body = json.dumps({"request": {
                    "uid": "u1",
                    "kind": {"group": "", "version": "v1",
                             "kind": "Namespace"},
                    "name": "bad-ns", "namespace": "",
                    "operation": "CREATE",
                    "userInfo": {"username": "alice"},
                    "object": {"apiVersion": "v1", "kind": "Namespace",
                               "metadata": {"name": "bad-ns",
                                            "labels": {}}},
                }}).encode()
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
                req = urllib.request.Request(
                    f"https://127.0.0.1:{app.webhook_server.port}/v1/admit",
                    data=body)
                with urllib.request.urlopen(req, context=ctx,
                                            timeout=10) as resp:
                    out = json.loads(resp.read())
                assert out["response"]["allowed"] is False

                # audit writes violations to constraint status via the
                # status subresource, over HTTP
                admin.create(ns("unlabeled"))
                deadline = time.monotonic() + 20
                st = {}
                while time.monotonic() < deadline:
                    st = admin.get(CGVK, "ns-must-have-gk").get(
                        "status") or {}
                    if st.get("violations"):
                        break
                    time.sleep(0.1)
                assert any(v["name"] == "unlabeled"
                           for v in st.get("violations", []))
            finally:
                app.stop()
        finally:
            srv.stop()


class TestRoleSplitPods:
    """The reference's production deployment shape (Makefile:30-75): a
    controller-manager pod (--operation webhook --operation status) and a
    separate audit pod (--operation audit --operation status), both
    against the same API server over the wire.  Each writes its own
    per-pod status CR; the aggregation controllers fold both into the
    parent's status.byPod (constraintstatus_controller.go:218)."""

    def test_two_pods_aggregate_and_split_roles(self, monkeypatch, tmp_path):
        import os

        from gatekeeper_tpu_torch.main import App, build_parser

        srv = KubeApiServer()
        srv.start()
        apps = []
        try:
            admin = HttpKube(srv.url, discovery_retry_s=2.0)
            for crd in load_deploy_crds():
                admin.create(crd)
            admin.create(ns("gatekeeper-system"))
            # each pod exists in the API so status CRs get owner refs
            for pname in ("gk-webhook-0", "gk-audit-0"):
                admin.create({"apiVersion": "v1", "kind": "Pod",
                              "metadata": {"name": pname,
                                           "namespace": "gatekeeper-system",
                                           "uid": f"uid-{pname}"},
                              "spec": {"containers": []}})

            def boot(pod_name, ops):
                monkeypatch.setitem(os.environ, "POD_NAME", pod_name)
                flags = ["--driver", "torch", "--torch-device", "cpu",
                         "--port", "0",
                         "--prometheus-port", "0", "--health-addr", ":0",
                         "--audit-interval", "0.1",
                         "--cert-dir", str(tmp_path / "certs")]
                for o in ops:
                    flags += ["--operation", o]
                app = App(build_parser().parse_args(flags),
                          kube=HttpKube(srv.url, discovery_retry_s=2.0))
                app.start()
                apps.append(app)
                return app

            webhook_pod = boot("gk-webhook-0", ["webhook", "status"])
            audit_pod = boot("gk-audit-0", ["audit", "status"])
            assert webhook_pod.webhook_server is not None
            assert webhook_pod.audit_manager is None
            assert audit_pod.webhook_server is None
            assert audit_pod.audit_manager is not None

            admin.create(json.loads(json.dumps(TEMPLATE)))
            admin.create(ns("unlabeled"))
            # wait for the template controller to synthesize + create the
            # constraint CRD, then create the constraint CR exactly once
            deadline = time.monotonic() + 20
            crd_ready = False
            while time.monotonic() < deadline:
                try:
                    admin.get(CRD_GVK,
                              "k8srequiredlabels.constraints.gatekeeper.sh")
                    crd_ready = True
                    break
                except (NotFound, KubeError):
                    time.sleep(0.1)
            assert crd_ready, "template controller never created the constraint CRD"
            admin.create(json.loads(json.dumps(CONSTRAINT)))

            # the audit pod writes violations to the shared constraint
            deadline = time.monotonic() + 25
            st = {}
            while time.monotonic() < deadline:
                try:
                    st = admin.get(CGVK, "ns-must-have-gk").get("status") or {}
                except Exception:
                    st = {}
                if st.get("violations") and len(st.get("byPod", [])) == 2:
                    break
                time.sleep(0.1)
            assert any(v["name"] == "unlabeled"
                       for v in st.get("violations", [])), st
            # both pods' status CRs folded into byPod, sorted by pod id
            ids = [s["id"] for s in st.get("byPod", [])]
            assert ids == ["gk-audit-0", "gk-webhook-0"], st.get("byPod")

            # the per-pod status CRs are owner-referenced to their pods
            sts = admin.list(("status.gatekeeper.sh", "v1beta1",
                              "ConstraintPodStatus"),
                             namespace="gatekeeper-system")
            owners = {
                (s["metadata"].get("ownerReferences") or [{}])[0].get("name")
                for s in sts
            }
            assert owners == {"gk-webhook-0", "gk-audit-0"}, sts

            # the webhook pod serves denials meanwhile
            body = json.dumps({"request": {
                "uid": "u1",
                "kind": {"group": "", "version": "v1", "kind": "Namespace"},
                "name": "bad-ns", "namespace": "", "operation": "CREATE",
                "userInfo": {"username": "alice"},
                "object": {"apiVersion": "v1", "kind": "Namespace",
                           "metadata": {"name": "bad-ns", "labels": {}}},
            }}).encode()
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            req = urllib.request.Request(
                f"https://127.0.0.1:{webhook_pod.webhook_server.port}/v1/admit",
                data=body)
            with urllib.request.urlopen(req, context=ctx, timeout=10) as resp:
                out = json.loads(resp.read())
            assert out["response"]["allowed"] is False
        finally:
            for app in apps:
                app.stop()
            srv.stop()


# ---- the audit over the wire (tests/test_audit_streaming.py) ---------------

N_BAD, N_GOOD = 7, 13


def _constraint_crd():
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "k8srequiredlabels.constraints.gatekeeper.sh"},
        "spec": {
            "group": "constraints.gatekeeper.sh",
            "names": {"kind": "K8sRequiredLabels",
                      "plural": "k8srequiredlabels"},
            "scope": "Cluster",
            "versions": [{"name": "v1beta1", "served": True,
                          "storage": True,
                          "subresources": {"status": {}}}],
        },
    }


def torch_client():
    client = Client(driver=TorchDriver(device="cpu"))
    client.add_template(json.loads(json.dumps(TEMPLATE)))
    client.add_constraint(json.loads(json.dumps(CONSTRAINT)))
    return client


def _world(kube):
    client = torch_client()
    kube.create(_constraint_crd())
    kube.create(json.loads(json.dumps(CONSTRAINT)))
    for i in range(N_BAD):
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": f"bad-{i:03d}", "labels": {}}})
    for i in range(N_GOOD):
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": f"good-{i:03d}",
                                  "labels": {"gatekeeper": "on"}}})
    return client


def test_streamed_audit_over_the_wire_matches_unchunked():
    """The same audit through the API server with chunk 4 and unchunked:
    the same violations and status."""
    results = {}
    for chunk in (4, 0):
        srv = KubeApiServer()
        srv.start()
        try:
            kube = HttpKube(srv.url, discovery_retry_s=1.0)
            client = _world(kube)
            mgr = AuditManager(kube, client, chunk_size=chunk)
            update_lists = mgr.audit_once()
            status = kube.get(CGVK, "ns-must-have-gk").get("status", {})
            results[chunk] = (
                {k: sorted(v.to_dict()["name"] for v in vs)
                 for k, vs in update_lists.items()},
                status.get("totalViolations"),
            )
        finally:
            srv.stop()
    assert results[4] == results[0]
    assert results[4][1] == N_BAD


def test_wire_pagination_issues_continue_tokens():
    srv = KubeApiServer()
    srv.start()
    try:
        kube = HttpKube(srv.url, discovery_retry_s=1.0)
        _world(kube)
        pages = list(kube.list_pages(("", "v1", "Namespace"), limit=6))
        assert len(pages) >= (N_BAD + N_GOOD) // 6
        assert all(len(p) <= 6 for p in pages)
        flat = [o["metadata"]["name"] for p in pages for o in p]
        assert len(flat) == N_BAD + N_GOOD
        assert len(set(flat)) == len(flat), "pages must not overlap"
        # every page item is usable as a full object (apiVersion restored)
        assert all(o.get("apiVersion") == "v1"
                   for p in pages for o in p)
    finally:
        srv.stop()


# ---- an API-server outage (tests/test_chaos.py) -----------------------------


@pytest.fixture()
def fault_plane():
    plane = faults.install(seed=1234)
    yield plane
    faults.uninstall()


class TestAuditOutage:
    def test_audit_survives_full_kube_outage_and_resumes(self, fault_plane):
        srv = KubeApiServer()
        srv.start()
        try:
            kube = HttpKube(srv.url, discovery_retry_s=1.0)
            client = Client(driver=TorchDriver(device="cpu"))
            # register the synthesized constraint CRD so the status-write
            # path can list (finding no constraint objects is fine)
            kube.create(client.add_template(json.loads(json.dumps(
                TEMPLATE))))
            client.add_constraint(json.loads(json.dumps(CONSTRAINT)))
            for i in range(2):
                kube.create({"apiVersion": "v1", "kind": "Namespace",
                             "metadata": {"name": f"bad-{i}", "labels": {}}})
            reporter = Reporters(Registry())
            am = AuditManager(kube, client, reporter=reporter,
                              interval_s=3600.0)

            assert am.run_once_guarded() is True
            assert am.last_run_status == "ok"
            assert am.consecutive_failures == 0

            # full outage: every kube HTTP send fails
            fault_plane.add(faults.KUBE_SEND, FaultRule(mode="error"))
            assert am.run_once_guarded() is False
            assert am.run_once_guarded() is False
            assert am.consecutive_failures == 2
            assert am.last_run_status == "error"
            rows = reporter.registry.view_rows("audit_consecutive_failures")
            assert rows.get(()) == 2.0
            assert reporter.registry.view_rows(
                "audit_last_run_status"
            ).get(()) == 0.0

            # recovery: the very next sweep succeeds and finds violations
            fault_plane.clear(faults.KUBE_SEND)
            assert am.run_once_guarded() is True
            assert am.consecutive_failures == 0
            assert am.last_run_status == "ok"
            assert reporter.registry.view_rows(
                "audit_last_run_status"
            ).get(()) == 1.0
            update_lists = am.audit_once()
            assert update_lists, "post-outage sweep must find violations"
            (violations,) = update_lists.values()
            assert {v.name for v in violations} == {"bad-0", "bad-1"}
        finally:
            srv.stop()


# ---- the card ---------------------------------------------------------------


def test_an_app_over_the_wire_needs_the_card(tmp_path):
    """--api-server <URL> with --driver torch on the default device (the
    card) fails at construction without one: no CPU fallback."""
    from gatekeeper_tpu_torch.main import App, build_parser

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    srv = KubeApiServer()
    srv.start()
    try:
        args = build_parser().parse_args([
            "--api-server", srv.url, "--driver", "torch",
            "--port", "0", "--prometheus-port", "0", "--health-addr", ":0",
            "--cert-dir", str(tmp_path / "certs")])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            App(args)
    finally:
        srv.stop()
