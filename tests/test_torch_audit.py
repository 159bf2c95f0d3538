"""Audit manager tests (reference parity: pkg/audit/manager.go semantics —
both sweep modes, caps, truncation, kind filtering, exclusion, status
writes).

The port's copy of tests/test_audit.py: the same scenarios on
gatekeeper_tpu_torch, on the interpreter driver and on TorchDriver on the
CPU."""

import json

import pytest

from gatekeeper_tpu_torch.audit import AuditManager
from gatekeeper_tpu_torch.audit.manager import truncate
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.metrics import Reporters
from gatekeeper_tpu_torch.metrics.views import Registry
from gatekeeper_tpu_torch.process.excluder import Excluder
from gatekeeper_tpu_torch.apis.config import MatchEntry

from .test_torch_controllers import CONSTRAINT, TEMPLATE

CGVK = ("constraints.gatekeeper.sh", "v1beta1", "K8sRequiredLabels")


@pytest.fixture(params=["interp", "torch-device"], autouse=True)
def _driver_mode(request):
    """Run the suite twice: on the interpreter driver and on TorchDriver
    on the CPU (the kernels' plain versions)."""
    global _MODE
    _MODE = request.param
    yield
    _MODE = "interp"


_MODE = "interp"


def new_client():
    if _MODE == "torch-device":
        from gatekeeper_tpu_torch.ops.driver import TorchDriver

        return Client(driver=TorchDriver(device="cpu"))
    return Client()


def setup_world(n_bad=3, n_good=2, **kw):
    kube = InMemoryKube()
    client = new_client()
    client.add_template(TEMPLATE)
    client.add_constraint(CONSTRAINT)
    kube.create(json.loads(json.dumps(CONSTRAINT)))
    for i in range(n_bad):
        obj = {"apiVersion": "v1", "kind": "Namespace",
               "metadata": {"name": f"bad-{i}", "labels": {}}}
        kube.create(obj)
        client.add_data(obj)
    for i in range(n_good):
        obj = {"apiVersion": "v1", "kind": "Namespace",
               "metadata": {"name": f"good-{i}",
                            "labels": {"gatekeeper": "on"}}}
        kube.create(obj)
        client.add_data(obj)
    mgr = AuditManager(kube, client, **kw)
    return mgr, kube, client


class TestAuditSweep:
    def test_discovery_mode_finds_violations(self):
        mgr, kube, client = setup_world()
        update_lists = mgr.audit_once()
        key = "K8sRequiredLabels//ns-must-have-gk"
        assert key in update_lists
        assert len(update_lists[key]) == 3
        st = kube.get(CGVK, "ns-must-have-gk")["status"]
        assert st["totalViolations"] == 3
        assert len(st["violations"]) == 3
        assert st["auditTimestamp"].endswith("Z")
        assert all(v["enforcementAction"] == "deny" for v in st["violations"])

    def test_from_cache_mode_matches_discovery(self):
        mgr_d, kube_d, _ = setup_world()
        mgr_c, kube_c, _ = setup_world(from_cache=True)
        d = mgr_d.audit_once()
        c = mgr_c.audit_once()
        dk = {k: sorted(v.name for v in vs) for k, vs in d.items()}
        ck = {k: sorted(v.name for v in vs) for k, vs in c.items()}
        assert dk == ck

    def test_violations_capped_but_totals_full(self):
        mgr, kube, client = setup_world(n_bad=30, violations_limit=5)
        mgr.audit_once()
        st = kube.get(CGVK, "ns-must-have-gk")["status"]
        assert len(st["violations"]) == 5
        assert st["totalViolations"] == 30

    def test_clean_sweep_removes_stale_violations(self):
        mgr, kube, client = setup_world()
        mgr.audit_once()
        assert kube.get(CGVK, "ns-must-have-gk")["status"]["violations"]
        # fix the world: all namespaces now labeled
        for gvk in [("", "v1", "Namespace")]:
            for obj in kube.list(gvk):
                obj["metadata"].setdefault("labels", {})["gatekeeper"] = "y"
                kube.update(obj)
                client.add_data(obj)
        mgr.audit_once()
        st = kube.get(CGVK, "ns-must-have-gk")["status"]
        assert "violations" not in st
        assert st["totalViolations"] == 0

    def test_excluded_namespace_skipped(self):
        excluder = Excluder()
        excluder.add([MatchEntry(excluded_namespaces=["skipme"],
                                 processes=["audit"])])
        kube = InMemoryKube()
        client = new_client()
        client.add_template(TEMPLATE)
        c = json.loads(json.dumps(CONSTRAINT))
        c["spec"]["match"] = {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}
        client.add_constraint(c)
        kube.create(c)
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": "skipme"}})
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "p1", "namespace": "skipme"}})
        mgr = AuditManager(kube, client, excluder=excluder)
        update_lists = mgr.audit_once()
        assert update_lists == {}

    def test_match_kind_only_filters(self):
        mgr, kube, client = setup_world(match_kind_only=True)
        # constraint matches only Namespace: Pods are not even listed
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "p1", "namespace": "bad-0"}})
        matched = mgr._matched_kinds(mgr._constraint_kinds())
        assert matched == {"Namespace"}
        update_lists = mgr.audit_once()
        assert len(update_lists) == 1

    def test_match_kind_only_star_when_no_kinds(self):
        mgr, kube, client = setup_world(match_kind_only=True)
        c = kube.get(CGVK, "ns-must-have-gk")
        del c["spec"]["match"]["kinds"]
        kube.update(c)
        assert mgr._matched_kinds(mgr._constraint_kinds()) == {"*"}

    def test_chunked_listing(self):
        mgr, kube, client = setup_world(n_bad=7, chunk_size=2)
        update_lists = mgr.audit_once()
        key = "K8sRequiredLabels//ns-must-have-gk"
        assert len(update_lists[key]) == 7

    def test_message_truncation(self):
        assert truncate("x" * 300) == "x" * 253 + "..."
        assert truncate("short") == "short"

    def test_metrics_and_events(self):
        events = []
        reporter = Reporters(Registry())
        mgr, kube, client = setup_world(
            reporter=reporter, emit_audit_events=True,
            event_recorder=events.append,
        )
        mgr.audit_once()
        assert reporter.registry.view_rows("violations")[("deny",)] == 3.0
        assert reporter.registry.view_rows("audit_duration_seconds")[()].count == 1
        assert reporter.registry.view_rows("audit_last_run_time")[()] > 0
        assert len(events) == 3
        assert events[0]["reason"] == "AuditViolation"

    def test_dryrun_totals_by_action(self):
        reporter = Reporters(Registry())
        mgr, kube, client = setup_world(reporter=reporter)
        dry = json.loads(json.dumps(CONSTRAINT))
        dry["metadata"]["name"] = "dry-run-one"
        dry["spec"]["enforcementAction"] = "dryrun"
        client.add_constraint(dry)
        kube.create(dry)
        mgr.audit_once()
        rows = reporter.registry.view_rows("violations")
        assert rows[("deny",)] == 3.0
        assert rows[("dryrun",)] == 3.0

    def test_periodic_loop(self):
        import time

        mgr, kube, client = setup_world(interval_s=0.05)
        mgr.start()
        try:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                st = kube.get(CGVK, "ns-must-have-gk").get("status") or {}
                if st.get("violations"):
                    break
                time.sleep(0.02)
            assert st.get("violations")
        finally:
            mgr.stop()

    def test_crd_gate(self):
        mgr, kube, client = setup_world(require_crd=True)
        assert mgr.audit_once() == {}
        kube.create({
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata":
                {"name": "constrainttemplates.templates.gatekeeper.sh"},
        })
        assert mgr.audit_once() != {}
