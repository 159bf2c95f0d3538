"""Watch manager + readiness tracker tests (reference parity:
pkg/watch/manager_test.go + manager_integration_test.go scenarios,
pkg/readiness/object_tracker_test.go + ready_tracker_test.go).

The port's copy of tests/test_watch_readiness.py, on
gatekeeper_tpu_torch."""

import queue
import time

import pytest

from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.readiness.tracker import (
    TEMPLATES_GVK,
    ObjectTracker,
    Tracker,
)
from gatekeeper_tpu_torch.watch.manager import ControllerSwitch, WatchManager
from gatekeeper_tpu_torch.watch.set import GVKSet

POD = ("", "v1", "Pod")
NS = ("", "v1", "Namespace")


def mkobj(gvk, name, ns=""):
    g, v, k = gvk
    api = v if not g else f"{g}/{v}"
    obj = {"apiVersion": api, "kind": k, "metadata": {"name": name}}
    if ns:
        obj["metadata"]["namespace"] = ns
    return obj


def drain(r, n, timeout=3.0):
    """Collect n events from a registrar queue."""
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        try:
            out.append(r.events.get(timeout=0.1))
        except queue.Empty:
            pass
    return out


class TestGVKSet:
    def test_ops(self):
        a = GVKSet([POD])
        b = GVKSet([POD, NS])
        assert a.union(b).equals(b)
        assert b.difference(a).items() == [NS]
        assert a.intersection(b).items() == [POD]
        a.add(NS)
        assert a.equals(b)
        a.remove(POD)
        assert a.items() == [NS]


class TestControllerSwitch:
    def test_gate(self):
        sw = ControllerSwitch()
        assert sw.enter()
        sw.stop()
        assert not sw.enter()


class TestWatchManager:
    def test_events_fan_out(self):
        kube = InMemoryKube()
        wm = WatchManager(kube)
        r1 = wm.new_registrar("c1")
        r2 = wm.new_registrar("c2")
        r1.add_watch(POD)
        r2.add_watch(POD)
        time.sleep(0.05)
        kube.create(mkobj(POD, "p1", "default"))
        ev1 = drain(r1, 1)
        ev2 = drain(r2, 1)
        assert ev1 and ev1[0][1].type == "ADDED"
        assert ev2 and ev2[0][1].object["metadata"]["name"] == "p1"
        wm.stop()

    def test_replay_to_late_joiner(self):
        # manager_integration_test.go:303 replay scenario
        kube = InMemoryKube()
        kube.create(mkobj(POD, "pre1", "default"))
        kube.create(mkobj(POD, "pre2", "default"))
        wm = WatchManager(kube)
        r = wm.new_registrar("late")
        r.add_watch(POD)
        evs = drain(r, 2)
        names = sorted(e[1].object["metadata"]["name"] for e in evs)
        assert names == ["pre1", "pre2"]
        assert all(e[1].type == "ADDED" for e in evs)
        wm.stop()

    def test_informer_removed_when_last_leaves(self):
        kube = InMemoryKube()
        wm = WatchManager(kube)
        r1 = wm.new_registrar("a")
        r2 = wm.new_registrar("b")
        r1.add_watch(POD)
        r2.add_watch(POD)
        assert wm.watched_gvks().contains(POD)
        r1.remove_watch(POD)
        assert wm.watched_gvks().contains(POD)  # r2 still wants it
        r2.remove_watch(POD)
        assert not wm.watched_gvks().contains(POD)
        wm.stop()

    def test_replace_watch_diffs(self):
        # manager.go:242-277 replaceWatches
        kube = InMemoryKube()
        wm = WatchManager(kube)
        r = wm.new_registrar("c")
        r.add_watch(POD)
        r.replace_watch([NS])
        assert r.watched().items() == [NS]
        assert not wm.watched_gvks().contains(POD)
        wm.stop()

    def test_events_after_replace_only_for_desired(self):
        kube = InMemoryKube()
        wm = WatchManager(kube)
        r = wm.new_registrar("c")
        r.replace_watch([POD, NS])
        time.sleep(0.05)
        kube.create(mkobj(NS, "ns1"))
        evs = drain(r, 1)
        assert evs[0][0] == NS
        r.replace_watch([POD])
        time.sleep(0.05)
        kube.create(mkobj(NS, "ns2"))
        kube.create(mkobj(POD, "p1", "ns1"))
        evs = drain(r, 1)
        assert evs[0][0] == POD
        wm.stop()

    def test_duplicate_registrar_rejected(self):
        wm = WatchManager(InMemoryKube())
        wm.new_registrar("x")
        with pytest.raises(Exception):
            wm.new_registrar("x")
        wm.stop()

    def test_remove_registrar_unwinds_watches(self):
        kube = InMemoryKube()
        wm = WatchManager(kube)
        r = wm.new_registrar("gone")
        r.add_watch(POD)
        wm.remove_registrar("gone")
        assert not wm.watched_gvks().contains(POD)
        wm.stop()


class TestObjectTracker:
    def test_not_satisfied_until_populated(self):
        t = ObjectTracker(POD)
        assert not t.satisfied()
        t.expectations_done()
        assert t.satisfied()  # no expectations -> trivially satisfied

    def test_expect_observe(self):
        t = ObjectTracker(POD)
        o = mkobj(POD, "p1", "default")
        t.expect(o)
        t.expectations_done()
        assert not t.satisfied()
        t.observe(o)
        assert t.satisfied()

    def test_cancel_expect(self):
        # object deleted during startup no longer blocks readiness
        t = ObjectTracker(POD)
        o = mkobj(POD, "p1", "default")
        t.expect(o)
        t.expectations_done()
        t.cancel_expect(o)
        assert t.satisfied()

    def test_try_cancel_threshold(self):
        t = ObjectTracker(POD)
        o = mkobj(POD, "p1", "default")
        t.expect(o)
        t.expectations_done()
        assert not t.try_cancel_expect(o)
        assert not t.try_cancel_expect(o)
        assert t.try_cancel_expect(o)  # third attempt cancels
        assert t.satisfied()

    def test_circuit_breaker(self):
        t = ObjectTracker(POD)
        t.expectations_done()
        assert t.satisfied()
        # post-satisfaction expects are ignored (circuit broken)
        t.expect(mkobj(POD, "p9", "default"))
        assert t.satisfied()


def mktemplate(name, kind):
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": name},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind}}},
            "targets": [
                {
                    "target": "admission.k8s.gatekeeper.sh",
                    "rego": "package x\nviolation[{\"msg\": \"m\"}] { 1 > 2 }",
                }
            ],
        },
    }


def mkconstraint(kind, name):
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": {},
    }


class TestTracker:
    def test_empty_cluster_satisfied(self):
        tr = Tracker()
        tr.run(InMemoryKube())
        assert tr.satisfied()

    def test_blocks_until_templates_observed(self):
        kube = InMemoryKube()
        kube.create(mktemplate("k8srequiredlabels", "K8sRequiredLabels"))
        tr = Tracker()
        tr.run(kube)
        assert not tr.satisfied()
        tr.for_gvk(TEMPLATES_GVK).observe(
            {"metadata": {"name": "k8srequiredlabels"}}
        )
        assert tr.satisfied()

    def test_blocks_on_constraints(self):
        kube = InMemoryKube()
        kube.create(mktemplate("k8srequiredlabels", "K8sRequiredLabels"))
        cgvk = ("constraints.gatekeeper.sh", "v1beta1", "K8sRequiredLabels")
        kube.create(mkconstraint("K8sRequiredLabels", "must-have"))
        tr = Tracker()
        tr.run(kube)
        tr.for_gvk(TEMPLATES_GVK).observe({"metadata": {"name": "k8srequiredlabels"}})
        assert not tr.satisfied()
        tr.for_gvk(cgvk).observe({"metadata": {"name": "must-have"}})
        assert tr.satisfied()

    def test_blocks_on_config_and_data(self):
        kube = InMemoryKube()
        kube.create(
            {
                "apiVersion": "config.gatekeeper.sh/v1alpha1",
                "kind": "Config",
                "metadata": {"name": "config", "namespace": "gatekeeper-system"},
                "spec": {"sync": {"syncOnly": [{"group": "", "version": "v1", "kind": "Pod"}]}},
            }
        )
        kube.create(mkobj(POD, "p1", "default"))
        tr = Tracker()
        tr.run(kube)
        assert not tr.satisfied()
        tr.config.observe({"metadata": {"name": "config", "namespace": "gatekeeper-system"}})
        assert not tr.satisfied()
        tr.for_data(POD).observe(mkobj(POD, "p1", "default"))
        assert tr.satisfied()

    def test_satisfaction_is_sticky(self):
        tr = Tracker()
        tr.run(InMemoryKube())
        assert tr.satisfied()
        # new expectations after satisfaction do not un-ready the pod
        tr.templates.expect({"metadata": {"name": "late"}})
        assert tr.satisfied()
