"""Controller tests (reference parity: pkg/controller/* envtest scenarios —
SURVEY.md section 4 tier 2, with InMemoryKube playing envtest's API server).

The port's copy of tests/test_controllers.py: the same scenarios on
gatekeeper_tpu_torch, on the interpreter driver and on TorchDriver on the
CPU."""

import time

import pytest

from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.controllers import Dependencies, Manager
from gatekeeper_tpu_torch.controllers.constraint import ConstraintsCache
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube, NotFound
from gatekeeper_tpu_torch.operations import Operations
from gatekeeper_tpu_torch.process.excluder import Excluder
from gatekeeper_tpu_torch.readiness.tracker import Tracker

TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8srequiredlabels"},
    "spec": {
        "crd": {
            "spec": {
                "names": {"kind": "K8sRequiredLabels"},
                "validation": {
                    "openAPIV3Schema": {
                        "properties": {
                            "labels": {"type": "array", "items": {"type": "string"}}
                        }
                    }
                },
            }
        },
        "targets": [
            {
                "target": "admission.k8s.gatekeeper.sh",
                "rego": """
package k8srequiredlabels

violation[{"msg": msg, "details": {"missing_labels": missing}}] {
  provided := {label | input.review.object.metadata.labels[label]}
  required := {label | label := input.parameters.labels[_]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("you must provide labels: %v", [missing])
}
""",
            }
        ],
    },
}

BAD_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8sbadrego"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "K8sBadRego"}}},
        "targets": [
            {"target": "admission.k8s.gatekeeper.sh", "rego": "this is not rego"}
        ],
    },
}

CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels",
    "metadata": {"name": "ns-must-have-gk"},
    "spec": {
        "match": {"kinds": [{"apiGroups": [""], "kinds": ["Namespace"]}]},
        "parameters": {"labels": ["gatekeeper"]},
    },
}

CRD_GVK = ("apiextensions.k8s.io", "v1", "CustomResourceDefinition")
CPS_GVK = ("status.gatekeeper.sh", "v1beta1", "ConstraintPodStatus")
CTPS_GVK = ("status.gatekeeper.sh", "v1beta1", "ConstraintTemplatePodStatus")
TEMPLATES_GVK = ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
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


def make_manager(kube=None, operations=None):
    kube = kube or InMemoryKube()
    client = new_client()
    deps = Dependencies(
        kube=kube,
        client=client,
        excluder=Excluder(),
        tracker=Tracker(),
        operations=operations or Operations(),
        pod_id="pod-1",
    )
    return Manager(deps), kube, client, deps


class TestTemplateLifecycle:
    def test_template_ingestion(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            # engine has the template
            assert client.templates() == ["K8sRequiredLabels"]
            # constraint CRD created with owner-ref
            crd = kube.get(CRD_GVK, "k8srequiredlabels.constraints.gatekeeper.sh")
            assert crd["metadata"]["ownerReferences"][0]["name"] == "k8srequiredlabels"
            # pod status written, no errors
            sts = kube.list(CTPS_GVK, "gatekeeper-system")
            assert len(sts) == 1 and sts[0]["status"]["errors"] == []
            # constraint kind is now watched
            assert mgr.constraint.registrar.watched().contains(CGVK)
        finally:
            mgr.stop()

    def test_bad_template_records_error_status(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(BAD_TEMPLATE))
            assert mgr.drain()
            assert client.templates() == []
            sts = kube.list(CTPS_GVK, "gatekeeper-system")
            assert len(sts) == 1
            assert sts[0]["status"]["errors"]
            assert "k8sbadrego" in sts[0]["metadata"]["name"]
        finally:
            mgr.stop()

    def test_template_delete_unwinds(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            kube.delete(TEMPLATES_GVK, "k8srequiredlabels")
            assert mgr.drain()
            time.sleep(0.1)
            assert client.templates() == []
            assert not mgr.constraint.registrar.watched().contains(CGVK)
            with __import__("pytest").raises(NotFound):
                kube.get(CRD_GVK, "k8srequiredlabels.constraints.gatekeeper.sh")
            assert kube.list(CTPS_GVK, "gatekeeper-system") == []
        finally:
            mgr.stop()


class TestConstraintLifecycle:
    def test_constraint_flows_through_dynamic_watch(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            kube.create(dict(CONSTRAINT))
            assert mgr.drain()
            time.sleep(0.1)
            # engine evaluates it
            res = client.review(
                {
                    "kind": {"group": "", "version": "v1", "kind": "Namespace"},
                    "name": "ns1",
                    "operation": "CREATE",
                    "object": {
                        "apiVersion": "v1",
                        "kind": "Namespace",
                        "metadata": {"name": "ns1"},
                    },
                }
            ).results()
            assert len(res) == 1 and "gatekeeper" in res[0].msg
            # pod status enforced
            sts = kube.list(CPS_GVK, "gatekeeper-system")
            assert len(sts) == 1 and sts[0]["status"]["enforced"]
        finally:
            mgr.stop()

    def test_invalid_constraint_records_error(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            bad = {
                "apiVersion": "constraints.gatekeeper.sh/v1beta1",
                "kind": "K8sRequiredLabels",
                "metadata": {"name": "bad-params"},
                "spec": {"parameters": {"labels": "not-an-array"}},
            }
            kube.create(bad)
            assert mgr.drain()
            time.sleep(0.1)
            sts = kube.list(CPS_GVK, "gatekeeper-system")
            assert len(sts) == 1 and sts[0]["status"]["errors"]
        finally:
            mgr.stop()

    def test_constraint_delete(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            kube.create(dict(CONSTRAINT))
            assert mgr.drain()
            time.sleep(0.1)
            kube.delete(CGVK, "ns-must-have-gk")
            assert mgr.drain()
            time.sleep(0.1)
            res = client.review(
                {
                    "kind": {"group": "", "version": "v1", "kind": "Namespace"},
                    "name": "ns1",
                    "object": {"apiVersion": "v1", "kind": "Namespace",
                               "metadata": {"name": "ns1"}},
                }
            ).results()
            assert res == []
            assert kube.list(CPS_GVK, "gatekeeper-system") == []
        finally:
            mgr.stop()


class TestConfigAndSync:
    CONFIG = {
        "apiVersion": "config.gatekeeper.sh/v1alpha1",
        "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {
            "sync": {"syncOnly": [{"group": "", "version": "v1", "kind": "Pod"}]},
            "match": [{"excludedNamespaces": ["kube-system"], "processes": ["*"]}],
        },
    }
    POD_GVK = ("", "v1", "Pod")

    def pod(self, name, ns):
        return {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": name, "namespace": ns}}

    def test_sync_replication(self):
        mgr, kube, client, deps = make_manager()
        kube.create(self.pod("pre", "default"))  # pre-existing: replay path
        mgr.start()
        try:
            kube.create(dict(self.CONFIG))
            assert mgr.drain()
            time.sleep(0.15)
            kube.create(self.pod("live", "default"))  # steady-state path
            assert mgr.drain()
            time.sleep(0.1)
            dump = client.dump()
            assert "pre" in dump and "live" in dump
        finally:
            mgr.stop()

    def test_excluded_namespace_not_synced(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(self.CONFIG))
            assert mgr.drain()
            time.sleep(0.1)
            kube.create(self.pod("secret", "kube-system"))
            assert mgr.drain()
            time.sleep(0.1)
            assert "secret" not in client.dump()
            assert deps.excluder.is_namespace_excluded("audit", "kube-system")
        finally:
            mgr.stop()

    def test_sync_set_shrink_wipes(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(self.CONFIG))
            assert mgr.drain()
            time.sleep(0.1)
            kube.create(self.pod("p1", "default"))
            assert mgr.drain()
            time.sleep(0.1)
            assert "p1" in client.dump()
            cfg = kube.get(("config.gatekeeper.sh", "v1alpha1", "Config"),
                           "config", "gatekeeper-system")
            cfg["spec"]["sync"]["syncOnly"] = []
            kube.update(cfg)
            assert mgr.drain()
            time.sleep(0.15)
            assert "p1" not in client.dump()
            # late pod events for the removed GVK are dropped
            kube.create(self.pod("p2", "default"))
            assert mgr.drain()
            time.sleep(0.1)
            assert "p2" not in client.dump()
        finally:
            mgr.stop()

    def test_a_pod_deleted_after_the_reconciles_listing_leaves_the_store(self):
        """The Config's first reconcile over an inventory restored before
        the controllers start lists what it keeps: a pod deleted just
        after that listing still leaves the store (the watch is live
        before the listing and delivers its DELETED), and a pod created
        then joins it."""
        listed = []
        pod = self.pod

        class Kube(InMemoryKube):
            def list_rvs(self, gvk):
                out = super().list_rvs(gvk)
                if gvk == TestConfigAndSync.POD_GVK and not listed:
                    listed.append(gvk)
                    self.delete(gvk, "pod-gone", "default")
                    self.create(pod("pod-late", "default"))
                return out

        mgr, kube, client, deps = make_manager(Kube())
        for name in ("pod-kept", "pod-gone"):
            kube.create(self.pod(name, "default"))
        for o in kube.list(self.POD_GVK):  # the restored inventory
            client.add_data(o)
        mgr.start(reset=False)
        try:
            kube.create(dict(self.CONFIG))
            assert mgr.drain()
            time.sleep(0.15)
            assert listed
            dump = client.dump()
            assert "pod-kept" in dump and "pod-late" in dump
            assert "pod-gone" not in dump
        finally:
            mgr.stop()


class TestStatusAggregation:
    def test_by_pod_fold(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            kube.create(dict(CONSTRAINT))
            assert mgr.drain()
            time.sleep(0.2)
            # our pod's status folded into the parent constraint
            parent = kube.get(CGVK, "ns-must-have-gk")
            by_pod = (parent.get("status") or {}).get("byPod") or []
            assert [s["id"] for s in by_pod] == ["pod-1"]
            # a second pod's status joins the fold, sorted by id
            other = {
                "apiVersion": "status.gatekeeper.sh/v1beta1",
                "kind": "ConstraintPodStatus",
                "metadata": {
                    "name": "pod--0-k8srequiredlabels-ns--must--have--gk",
                    "namespace": "gatekeeper-system",
                    "labels": {
                        "internal.gatekeeper.sh/constraint-name": "ns-must-have-gk",
                        "internal.gatekeeper.sh/constraint-kind": "K8sRequiredLabels",
                        "internal.gatekeeper.sh/pod": "pod-0",
                    },
                },
                "status": {"id": "pod-0", "enforced": True, "errors": []},
            }
            kube.create(other)
            assert mgr.drain()
            time.sleep(0.2)
            parent = kube.get(CGVK, "ns-must-have-gk")
            assert [s["id"] for s in parent["status"]["byPod"]] == ["pod-0", "pod-1"]
        finally:
            mgr.stop()

    def test_template_status_created_flag(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            time.sleep(0.2)
            t = kube.get(TEMPLATES_GVK, "k8srequiredlabels")
            assert t["status"]["created"] is True
            assert [s["id"] for s in t["status"]["byPod"]] == ["pod-1"]
        finally:
            mgr.stop()

    def test_uid_drift_dropped(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            c = dict(CONSTRAINT)
            kube.create(c)
            assert mgr.drain()
            time.sleep(0.2)
            # recreate the constraint: new UID; stale status must not fold
            kube.delete(CGVK, "ns-must-have-gk")
            assert mgr.drain()
            time.sleep(0.1)
            stale = {
                "apiVersion": "status.gatekeeper.sh/v1beta1",
                "kind": "ConstraintPodStatus",
                "metadata": {
                    "name": "pod--9-k8srequiredlabels-ns--must--have--gk",
                    "namespace": "gatekeeper-system",
                    "labels": {
                        "internal.gatekeeper.sh/constraint-name": "ns-must-have-gk",
                        "internal.gatekeeper.sh/constraint-kind": "K8sRequiredLabels",
                        "internal.gatekeeper.sh/pod": "pod-9",
                    },
                },
                "status": {"id": "pod-9", "constraintUID": "stale-uid", "enforced": True},
            }
            kube.create(stale)
            kube.create(dict(CONSTRAINT))
            assert mgr.drain()
            time.sleep(0.2)
            parent = kube.get(CGVK, "ns-must-have-gk")
            ids = [s["id"] for s in parent["status"]["byPod"]]
            assert "pod-9" not in ids and "pod-1" in ids
        finally:
            mgr.stop()


class TestReadinessIntegration:
    def test_startup_gate(self):
        kube = InMemoryKube()
        kube.create(dict(TEMPLATE))
        kube.create(dict(CONSTRAINT))
        mgr, kube, client, deps = make_manager(kube=kube)
        deps.tracker.run(kube)
        assert not deps.tracker.satisfied()
        mgr.start()
        try:
            assert deps.tracker.wait_satisfied(timeout=5.0)
        finally:
            mgr.stop()


class TestConstraintsCache:
    def test_totals(self):
        c = ConstraintsCache()
        c.add("K", "a", "deny", "active")
        c.add("K", "b", "deny", "active")
        c.add("K", "c", "dryrun", "error")
        assert c.totals() == {("deny", "active"): 2, ("dryrun", "error"): 1}
        c.remove("K", "b")
        assert c.totals()[("deny", "active")] == 1


class TestConvergence:
    def test_write_back_loops_converge(self):
        """Regression: status aggregation + parent controllers must not form
        an infinite reconcile feedback loop (no-op updates emit no events)."""
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            kube.create(dict(CONSTRAINT))
            assert mgr.drain()
            time.sleep(0.5)
            rv1 = kube.get(CGVK, "ns-must-have-gk")["metadata"]["resourceVersion"]
            time.sleep(0.5)
            rv2 = kube.get(CGVK, "ns-must-have-gk")["metadata"]["resourceVersion"]
            assert rv1 == rv2, f"constraint still churning: {rv1} -> {rv2}"
            trv1 = kube.get(TEMPLATES_GVK, "k8srequiredlabels")["metadata"]["resourceVersion"]
            time.sleep(0.3)
            trv2 = kube.get(TEMPLATES_GVK, "k8srequiredlabels")["metadata"]["resourceVersion"]
            assert trv1 == trv2
        finally:
            mgr.stop()


class TestReadinessRegression:
    def test_cancel_template_cancels_constraint_kind(self):
        from gatekeeper_tpu_torch.readiness.tracker import Tracker

        kube = InMemoryKube()
        kube.create(dict(TEMPLATE))
        kube.create(dict(CONSTRAINT))
        tr = Tracker()
        tr.run(kube)
        assert not tr.satisfied()
        # template deleted before its constraints were observed
        tr.for_gvk(TEMPLATES_GVK).observe({"metadata": {"name": "other"}})
        tr.cancel_template(kube.get(TEMPLATES_GVK, "k8srequiredlabels"))
        assert tr.satisfied()

    def test_late_tracker_born_populated(self):
        from gatekeeper_tpu_torch.readiness.tracker import Tracker

        tr = Tracker()
        tr.run(InMemoryKube())
        # a kind appearing after seeding must not block readiness
        late = tr.for_gvk(("constraints.gatekeeper.sh", "v1beta1", "K8sLate"))
        assert late.populated
        data = tr.for_data(("", "v1", "Secret"))
        assert data.populated
        assert tr.satisfied()


class TestSyncPrune:
    def test_counts_pruned_on_sync_set_shrink(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TestConfigAndSync.CONFIG))
            assert mgr.drain()
            time.sleep(0.1)
            kube.create({"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": "p1", "namespace": "default"}})
            assert mgr.drain()
            time.sleep(0.1)
            assert mgr.sync.counts() == {("", "v1", "Pod"): 1}
            cfg = kube.get(("config.gatekeeper.sh", "v1alpha1", "Config"),
                           "config", "gatekeeper-system")
            cfg["spec"]["sync"]["syncOnly"] = []
            kube.update(cfg)
            assert mgr.drain()
            time.sleep(0.15)
            assert mgr.sync.counts() == {}
        finally:
            mgr.stop()


class TestReadinessRegressions:
    """Deadlock scenarios from review: excluded/deleted/mis-named objects
    must not block readiness forever."""

    def _config(self, sync_only, match=None):
        return {
            "apiVersion": "config.gatekeeper.sh/v1alpha1",
            "kind": "Config",
            "metadata": {"name": "config", "namespace": "gatekeeper-system"},
            "spec": {
                "sync": {"syncOnly": sync_only},
                "match": match or [],
            },
        }

    def test_excluded_namespace_objects_do_not_block_readiness(self):
        kube = InMemoryKube()
        kube.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p1", "namespace": "kube-system"},
        })
        kube.create(self._config(
            [{"group": "", "version": "v1", "kind": "Pod"}],
            match=[{"excludedNamespaces": ["kube-system"],
                    "processes": ["sync"]}],
        ))
        mgr, kube, client, deps = make_manager(kube=kube)
        deps.tracker.run(kube)
        mgr.start()
        try:
            assert mgr.drain()
            assert deps.tracker.wait_satisfied(timeout=5.0)
        finally:
            mgr.stop()

    def test_non_singleton_config_name_not_expected(self):
        kube = InMemoryKube()
        kube.create({
            "apiVersion": "config.gatekeeper.sh/v1alpha1",
            "kind": "Config",
            "metadata": {"name": "not-the-singleton",
                         "namespace": "gatekeeper-system"},
            "spec": {},
        })
        mgr, kube, client, deps = make_manager(kube=kube)
        deps.tracker.run(kube)
        mgr.start()
        try:
            assert mgr.drain()
            assert deps.tracker.wait_satisfied(timeout=5.0)
        finally:
            mgr.stop()

    def test_object_deleted_before_watch_start_is_collected(self):
        kube = InMemoryKube()
        kube.create(dict(TEMPLATE))
        mgr, kube, client, deps = make_manager(kube=kube)
        deps.tracker.run(kube)  # template now expected
        # deleted before any watch exists: no tombstone will ever arrive
        kube.delete(TEMPLATES_GVK, "k8srequiredlabels")
        mgr.start()  # start() runs tracker.collect(kube)
        try:
            assert mgr.drain()
            assert deps.tracker.wait_satisfied(timeout=5.0)
        finally:
            mgr.stop()

    def test_status_write_back_does_not_clobber_spec(self):
        mgr, kube, client, deps = make_manager()
        mgr.start()
        try:
            kube.create(dict(TEMPLATE))
            assert mgr.drain()
            kube.create(dict(CONSTRAINT))
            assert mgr.drain()
            time.sleep(0.2)
            # spec survived the status controller's parent write-backs
            live = kube.get(CGVK, "ns-must-have-gk")
            assert live["spec"]["parameters"] == {"labels": ["gatekeeper"]}
            assert live.get("status", {}).get("byPod")
        finally:
            mgr.stop()
