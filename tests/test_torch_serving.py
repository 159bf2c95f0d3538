"""TorchDriver's serving seam on the CPU: the circuit breaker, the request
and review memos and the three tiers' service model, held to the JAX
package.

Every review and audit result here, memo hits and breaker diverts
included, is compared byte for byte (constraint, message, enforcement
action, metadata) with the port's InterpDriver oracle, and where the JAX
tests compare with TpuDriver, with TpuDriver on the CPU JAX backend
(``DEVICE_MIN_CELLS = 0``, so its device path serves).  On one sequence of
reviews and constraint changes, the port's request-memo hits and misses
equal TpuDriver's.  The cases follow tests/test_chaos.py (TestCircuitBreaker
and the stalls of TestMeshDispatchStall), the memo tests of
tests/test_tpu_driver.py, the model tests of tests/test_routing_load.py,
tests/test_routeledger.py's TestDriverRecording, tests/test_fleet.py's
adaptive batcher and the request-memo counter of tests/test_tracing.py;
the port prices TpuDriver's three tiers (the device, the numpy host tier
and the interpreter), and a batch the breaker or an unavailable device
diverts is served by the numpy tier.  The fixtures that hold the device
path force it, as their JAX twins do (``DEVICE_MIN_CELLS = 0``).  Then
the port's own: a status-only re-put keeps a memo hit, a divert is
counted and reads degraded on /healthz, a device error is never served by
a host tier, on the card (price_host_tiers off) a batch priced for a host
tier is served by the device, the App takes the breaker flags and
calibrates, and a join divergence is recorded with GK_JOIN_ASSERT
unset."""

import copy
import json
import ssl
import time
import urllib.request

import pytest

from gatekeeper_tpu.client.client import Client as JaxClient
from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu_torch import deadline as tdeadline
from gatekeeper_tpu_torch import faults
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.client.drivers import InterpDriver
from gatekeeper_tpu_torch.faults import FaultRule
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.main import App, build_parser
from gatekeeper_tpu_torch.metrics.views import global_registry
from gatekeeper_tpu_torch.obs.debug import get_router
from gatekeeper_tpu_torch.ops import joinkernel
from gatekeeper_tpu_torch.ops.breaker import CLOSED, OPEN, CircuitBreaker
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.parallel import mesh as pm
from gatekeeper_tpu_torch.target.target import AugmentedReview
from gatekeeper_tpu_torch.util import synthetic as syn
from gatekeeper_tpu_torch.webhook import (
    MicroBatcher,
    ValidationHandler,
    WebhookServer,
)

from .test_controllers import CONSTRAINT, TEMPLATE

PROBE_NAME = "gk-breaker-probe"


@pytest.fixture()
def fault_plane():
    plane = faults.install(seed=1234)
    yield plane
    faults.uninstall()


def ns_review(name, labels=None):
    return {
        "uid": f"uid-{name}",
        "kind": {"group": "", "version": "v1", "kind": "Namespace"},
        "name": name,
        "namespace": "",
        "operation": "CREATE",
        "userInfo": {"username": "alice"},
        "object": {
            "apiVersion": "v1",
            "kind": "Namespace",
            "metadata": {"name": name, "labels": labels or {}},
        },
    }


def pod_request(pod, uid="u1"):
    return {"uid": uid,
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": pod["metadata"]["name"],
            "namespace": pod["metadata"].get("namespace", "default"),
            "operation": "CREATE", "object": pod}


def result_bytes(results):
    """One review's results, in order, as bytes."""
    return [json.dumps([r.constraint["kind"], r.constraint["metadata"]["name"],
                        r.msg, r.enforcement_action, r.metadata],
                       sort_keys=True, default=str)
            for r in results]


def port_client(threshold=3, cooldown=0.05, **kw):
    driver = TorchDriver(device="cpu", breaker_threshold=threshold,
                         breaker_cooldown_s=cooldown, **kw)
    driver.DEVICE_MIN_CELLS = 0  # the device path for unique content
    client = Client(driver=driver)
    client.add_template(TEMPLATE)
    client.add_constraint(CONSTRAINT)
    return client, driver


def oracle_client():
    client = Client(driver=InterpDriver())
    client.add_template(TEMPLATE)
    client.add_constraint(CONSTRAINT)
    return client


def wait_until(cond, timeout_s=5.0, step_s=0.01):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(step_s)
    return cond()


def view(name):
    return global_registry().view_rows(name)


def route_count(tier, reason):
    got = view("route_decisions_total").get((tier, reason))
    return float(got or 0.0)


# ---- the circuit breaker (tests/test_chaos.py TestCircuitBreaker) ----------


class TestCircuitBreaker:
    def test_trips_serves_interp_identical_and_recovers(self, fault_plane):
        client, driver = port_client(threshold=3, cooldown=0.05)
        oracle = oracle_client()
        dispatched = []  # review names per compute_masks call
        orig = driver.compute_masks

        def counting(reviews):
            dispatched.extend(r.get("name", "?") for r in reviews)
            return orig(reviews)

        driver.compute_masks = counting

        def traffic():
            return [n for n in dispatched if n != PROBE_NAME]

        def same(name, labels=None):
            req = ns_review(name, labels)
            got = client.review(AugmentedReview(admission_request=req))
            want = oracle.review(AugmentedReview(admission_request=req))
            assert result_bytes(got.results()) == \
                result_bytes(want.results())
            return got

        same("warm")
        assert driver.breaker.state == CLOSED
        assert traffic(), "a healthy review must reach the device path"
        failed_before = route_count("np", "device_failed")

        fault_plane.add(faults.TPU_DISPATCH, FaultRule(mode="error"))
        # each failed batch still answers, from the numpy host tier
        for i in range(3):
            same(f"fail-{i}")
        st = driver.breaker.status()
        assert st["state"] != "closed" and st["trips"] >= 1
        assert route_count("np", "device_failed") == failed_before + 3

        # while degraded no traffic reaches the device; deny and allow
        n_before = len(traffic())
        open_before = route_count("np", "breaker_open")
        for i in range(4):
            labels = {"gatekeeper": "on"} if i % 2 else None
            got = same(f"degraded-{i}", labels)
            assert len(got.results()) == (0 if labels else 1)
        assert len(traffic()) == n_before
        assert route_count("np", "breaker_open") >= open_before + 1

        # the background half-open probe closes it, without traffic
        fault_plane.clear(faults.TPU_DISPATCH)
        assert wait_until(lambda: driver.breaker.state == CLOSED), \
            driver.breaker.status()
        assert dispatched.count(PROBE_NAME) >= 1

        same("recovered")
        assert len(traffic()) > n_before
        assert driver.breaker_status()["consecutive_failures"] == 0

    def test_breaker_transitions_land_in_metrics(self, fault_plane):
        client, driver = port_client(threshold=2, cooldown=30.0)
        fault_plane.add(faults.TPU_DISPATCH, FaultRule(mode="error"))
        for i in range(2):
            client.review(AugmentedReview(admission_request=ns_review(
                f"m-{i}")))
        assert driver.breaker.state == OPEN
        assert view("tpu_breaker_state").get(()) == 2.0  # open
        assert view("tpu_breaker_trips").get(()) >= 1.0
        fault_plane.clear(faults.TPU_DISPATCH)
        assert driver.breaker.probe_now()
        assert driver.breaker.state == CLOSED
        assert view("tpu_breaker_state").get(()) == 0.0

    def test_degraded_seconds_span_failed_trials(self):
        t = [0.0]
        cb = CircuitBreaker(failure_threshold=1, cooldown_s=5.0,
                            clock=lambda: t[0])
        cb.record_failure()  # trips at t=0
        t[0] = 10.0
        assert cb.allow()  # lazy half-open trial
        cb.record_failure()  # failed trial: open again
        t[0] = 20.0
        assert cb.status()["degraded_seconds"] == 20.0
        assert cb.allow()
        cb.record_success()
        assert cb.state == CLOSED
        assert cb.status()["degraded_seconds"] == 20.0

    def test_breaker_state_visible_on_health_endpoints(self):
        client, driver = port_client()
        handler = ValidationHandler(client, kube=InMemoryKube())
        srv = WebhookServer(
            handler, port=0,
            health_status=lambda: {"tpu_breaker": driver.breaker_status()},
        )
        srv.start()
        try:
            def get(path):
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}{path}", timeout=5
                ) as r:
                    return r.status, r.read()

            assert get("/healthz") == (200, b"ok")
            driver.breaker.trip()
            assert get("/healthz") == (200, b"ok (degraded)")
            code, body = get("/statusz")
            st = json.loads(body)["tpu_breaker"]
            assert code == 200 and st["state"] == "open" and st["trips"] == 1
            driver.breaker.record_success()
            assert get("/healthz") == (200, b"ok")
        finally:
            srv.stop()

    def test_degraded_audit_matches_interpreter(self):
        client, driver = port_client()
        oracle = oracle_client()
        for c in (client, oracle):
            for i in range(3):
                c.add_data({"apiVersion": "v1", "kind": "Namespace",
                            "metadata": {"name": f"bad-{i}", "labels": {}}})
            c.add_data({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": "good",
                                     "labels": {"gatekeeper": "on"}}})
        want_resp, want_totals = oracle.audit_capped(20)
        driver.breaker.trip()
        before = route_count("interp", "breaker_open")

        def no_device(*a, **k):
            raise AssertionError("device sweep ran while the breaker is open")

        driver._audit_sweep = no_device
        got_resp, got_totals = client.audit_capped(20)
        assert got_totals == want_totals
        assert sorted(result_bytes(got_resp.results())) == sorted(
            result_bytes(want_resp.results()))
        assert sorted(result_bytes(client.audit().results())) == sorted(
            result_bytes(oracle.audit().results()))
        assert route_count("interp", "breaker_open") == before + 2
        driver.breaker.record_success()
        del driver._audit_sweep
        got_resp, got_totals = client.audit_capped(20)
        assert got_totals == want_totals
        assert driver.last_sweep_stats.get("rows") == 4.0

    @pytest.mark.parametrize("path", ["review_batch", "audit",
                                      "audit_capped"])
    def test_a_kernel_launch_failure_reaches_the_caller(self, path,
                                                        monkeypatch):
        """Only an unavailable device diverts: a kernel's refused launch
        (the error device.launch raises) raises out of the serving
        method, feeds no breaker and records no divert."""
        from gatekeeper_tpu_torch.ops import driver as tdriver

        client, driver = port_client(threshold=1)
        client.add_data({"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": "bad-0", "labels": {}}})

        def refused(*_a, **_kw):
            raise RuntimeError("kernel match launch failed: an illegal "
                               "memory access was encountered (700)")

        monkeypatch.setattr(tdriver, "match_kernel", refused)
        diverts = [route_count(t, r) for t in ("np", "interp")
                   for r in ("device_failed", "breaker_open")]
        call = {
            "review_batch": lambda: driver.review_batch(
                [ns_review("launch")]),
            "audit": driver.audit,
            "audit_capped": lambda: driver.audit_capped(20),
        }[path]
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
        assert driver.breaker.state == CLOSED
        assert driver.breaker_status()["consecutive_failures"] == 0
        assert [route_count(t, r) for t in ("np", "interp")
                for r in ("device_failed", "breaker_open")] == diverts

    @pytest.mark.parametrize("error", [
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered"),
        ValueError("K9's blob is malformed"),
        MemoryError("CUDA out of memory"),
    ], ids=["cuda", "value", "memory"])
    def test_a_device_error_is_never_served_by_the_host_tiers(self, error):
        """compute_masks raising anything but DeviceUnavailable (or a
        mesh stall) on a batch priced for the device raises out of
        review_batch: the numpy tier and the interpreter never answer it,
        the breaker is not fed, and the ledger holds the device entry
        alone."""
        client, driver = port_client(threshold=1)
        served = []
        orig_np, orig_walk = driver._np_review, driver._interp_serve
        driver._np_review = lambda *a, **kw: served.append("np") or \
            orig_np(*a, **kw)
        driver._interp_serve = lambda *a, **kw: served.append("interp") \
            or orig_walk(*a, **kw)

        def failing(_reviews):
            raise error

        driver.compute_masks = failing
        driver.route_ledger.clear()
        with pytest.raises(type(error)):
            driver.review_batch([ns_review("device-error")])
        assert served == []
        assert driver.breaker.state == CLOSED
        assert driver.breaker_status()["consecutive_failures"] == 0
        assert [(e["tier"], e["reason"]) for e in _entries(driver)] == [
            ("device", "forced_device")]


# ---- a stalled mesh dispatch (tests/test_chaos.py TestMeshDispatchStall) ----


class TestMeshDispatchStall:
    """A wedged mesh dispatch must not hold the sweep (or the dispatch
    gate) for ever: the watchdog abandons it, narrows the mesh and trips
    the breaker (interpreter-identical answers meanwhile); the rebasing
    full sweep at the new width equals the oracle."""

    @pytest.fixture(autouse=True)
    def _virtual_mesh(self, monkeypatch):
        monkeypatch.setenv(pm.VIRTUAL_DEVICES_ENV, "8")
        monkeypatch.delenv("GK_MESH", raising=False)

    def _populate(self, *clients, n=6):
        for c in clients:
            for i in range(n):
                labels = {"gatekeeper": "on"} if i % 2 else {}
                c.add_data({"apiVersion": "v1", "kind": "Namespace",
                            "metadata": {"name": f"m-{i}",
                                         "labels": labels}})

    def _audit_sig(self, client):
        resp, totals = client.audit_capped(20)
        return sorted(result_bytes(resp.results())), totals

    @pytest.mark.parametrize("width,narrower", [(4, 2), (2, 1)])
    def test_stall_trips_breaker_and_narrows_mesh(self, fault_plane, width,
                                                  narrower):
        client, driver = port_client(threshold=3, cooldown=30.0,
                                     mesh_watchdog_s=0.25)
        oracle = oracle_client()
        self._populate(client, oracle)
        driver.set_mesh(True, width=width)
        want = self._audit_sig(oracle)
        revocations = pm.DISPATCH_LOCK.revocations
        fault_plane.add(faults.MESH_DISPATCH_STALL,
                        FaultRule(mode="hang", hang_s=10.0, count=1))
        assert self._audit_sig(client) == want  # the interpreter answered
        assert driver.breaker.state == OPEN, driver.breaker.status()
        assert driver.mesh_layout() == narrower
        assert pm.DISPATCH_LOCK.revocations == revocations + 1
        # while degraded every sweep is the interpreter's
        assert self._audit_sig(client) == want
        fault_plane.release_hangs()
        time.sleep(0.3)
        fault_plane.clear(faults.MESH_DISPATCH_STALL)
        assert driver.breaker.probe_now(), driver.breaker.status()
        assert self._audit_sig(client) == want
        stats = driver.last_sweep_stats
        assert stats.get("shards") == float(narrower), stats
        assert not stats.get("cached")


# ---- the memos (tests/test_tpu_driver.py) -----------------------------------


def _corpus_clients(n=6, seed=13):
    """The port on the CPU, its oracle, and TpuDriver on the CPU JAX
    backend with its device path forced, each holding the same
    synthetic templates."""
    templates, constraints = syn.make_templates(n, seed=seed)
    port = Client(driver=TorchDriver(device="cpu"))
    port.driver.DEVICE_MIN_CELLS = 0
    oracle = Client(driver=InterpDriver())
    tpu = TpuDriver()
    tpu.DEVICE_MIN_CELLS = 0
    jax = JaxClient(driver=tpu)
    for c in (port, oracle, jax):
        for t, k in zip(templates, constraints):
            c.add_template(copy.deepcopy(t))
            c.add_constraint(copy.deepcopy(k))
    return port, oracle, jax


def _spy_memo(driver):
    """Count the request memo's probe outcomes: [hits, misses]."""
    counts = [0, 0]
    probe = driver._request_memo_hit

    def spied(review):
        out = probe(review)
        counts[0 if out[0] is not None else 1] += 1
        return out

    driver._request_memo_hit = spied
    return counts


class TestMemos:
    def test_device_path_memoizes_repeated_requests(self):
        """A repeated request renders nothing and launches nothing again,
        its results equal to the oracle's and TpuDriver's, also after a
        constraint change invalidated the entry."""
        port, oracle, jax = _corpus_clients()
        pod = syn.make_pods(1, seed=3, violation_rate=1.0)[0]
        req = pod_request(pod, uid="u")
        calls = []
        orig = port.driver.compute_masks
        port.driver.compute_masks = lambda rs: calls.append(len(rs)) or \
            orig(rs)
        first_results = port.review(req).results()
        first = result_bytes(first_results)
        assert first == result_bytes(oracle.review(req).results())
        assert first == result_bytes(jax.review(req).results())
        assert port.driver._review_memo and port.driver._request_memo
        assert result_bytes(port.review(req).results()) == first
        assert calls == [1]  # the repeat launched nothing
        # a real constraint change: the repeat is repaired, not replayed
        k2 = copy.deepcopy(first_results[0].constraint)
        k2["spec"]["enforcementAction"] = "dryrun"
        for c in (port, oracle, jax):
            c.add_constraint(copy.deepcopy(k2))
        got = result_bytes(port.review(req).results())
        assert got == result_bytes(oracle.review(req).results())
        assert got == result_bytes(jax.review(req).results())
        assert got != first
        res_t, trace_t = port.driver.review(req, tracing=True)
        assert trace_t is not None and "match" in trace_t

    def test_memo_excluded_for_clock_and_uid_policies(self):
        clock = 'package clocky\nviolation[{"msg": "tick"}] {\n' \
            '  time.now_ns() > 0\n}\n'
        uid = 'package uidy\nviolation[{"msg": msg}] {\n' \
            '  msg := sprintf("uid %v", [input.review.uid])\n}\n'
        safe = 'package safe\nviolation[{"msg": "no-labels"}] {\n' \
            '  not input.review.object.metadata.labels.owner\n}\n'

        def tpl(kind, rego):
            return {"apiVersion": "templates.gatekeeper.sh/v1beta1",
                    "kind": "ConstraintTemplate",
                    "metadata": {"name": kind.lower()},
                    "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                             "targets": [{"target":
                                          "admission.k8s.gatekeeper.sh",
                                          "rego": rego}]}}

        c = Client(driver=TorchDriver(device="cpu"))
        for kind, rego in (("Clocky", clock), ("Uidy", uid), ("Safe", safe)):
            c.add_template(tpl(kind, rego))
            c.add_constraint({
                "apiVersion": "constraints.gatekeeper.sh/v1beta1",
                "kind": kind, "metadata": {"name": f"c{kind.lower()}"},
                "spec": {"match": {"kinds": [
                    {"apiGroups": [""], "kinds": ["Pod"]}]}}})
        d = c.driver
        assert not d.templates["Clocky"].policy.memo_safe
        assert not d.templates["Uidy"].policy.memo_safe
        assert d.templates["Safe"].policy.memo_safe

        def req(u):
            return {"uid": u,
                    "kind": {"group": "", "version": "v1", "kind": "Pod"},
                    "name": "p", "namespace": "d", "operation": "CREATE",
                    "object": {"apiVersion": "v1", "kind": "Pod",
                               "metadata": {"name": "p", "namespace": "d"}}}

        r1 = {x.constraint["kind"]: x.msg for x in c.review(req("uid-1"))
              .results()}
        r2 = {x.constraint["kind"]: x.msg for x in c.review(req("uid-2"))
              .results()}
        assert r1["Uidy"] == "uid uid-1" and r2["Uidy"] == "uid uid-2"
        assert any(k[0] == "Safe" for k in d._review_memo)
        assert not any(k[0] in ("Uidy", "Clocky") for k in d._review_memo)
        assert d._memoable_synced() is False and not d._request_memo

    def test_hit_rebinds_review_and_matches_oracle(self):
        port, oracle, jax = _corpus_clients()
        pod = syn.make_pods(1, seed=13, violation_rate=1.0)[0]
        r1 = port.review(pod_request(pod, uid="a")).results()
        assert port.driver._request_memo
        r2 = port.review(pod_request(pod, uid="b")).results()  # a hit
        want = oracle.review(pod_request(pod, uid="b")).results()
        assert result_bytes(r1) == result_bytes(r2) == result_bytes(want)
        assert result_bytes(r2) == result_bytes(
            jax.review(pod_request(pod, uid="b")).results())
        assert all(x.review["uid"] == "b" for x in r2)
        # a replayed result's details are its own copy
        r2[0].metadata["details"]["mutated"] = True
        r3 = port.review(pod_request(pod, uid="c")).results()
        assert result_bytes(r3) == result_bytes(want)

    def test_constraint_removal_invalidates(self):
        port, _oracle, _jax = _corpus_clients()
        pod = syn.make_pods(1, seed=13, violation_rate=1.0)[0]
        assert port.review(pod_request(pod)).results()
        for kind in list(port.driver.constraints):
            for name in list(port.driver.constraints[kind]):
                port.remove_constraint(port.driver.constraints[kind][name])
        assert port.review(pod_request(pod)).results() == []

    def test_not_memoable_with_namespace_selector(self):
        port, oracle, _jax = _corpus_clients()
        kind = next(iter(port.driver.constraints))
        name = next(iter(port.driver.constraints[kind]))
        cons = copy.deepcopy(port.driver.constraints[kind][name])
        cons["spec"].setdefault("match", {})["namespaceSelector"] = {
            "matchLabels": {"team": "x"}}
        port.add_constraint(copy.deepcopy(cons))
        oracle.add_constraint(cons)
        pod = syn.make_pods(1, seed=13)[0]
        got = port.review(pod_request(pod)).results()
        assert result_bytes(got) == result_bytes(
            oracle.review(pod_request(pod)).results())
        assert port.driver._memoable_synced() is False
        assert not port.driver._request_memo

    def test_not_memoable_with_wallclock_policy(self):
        port, _oracle, _jax = _corpus_clients()
        port.add_template({
            "apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": "k8sclocky"},
            "spec": {"crd": {"spec": {"names": {"kind": "K8sClocky"}}},
                     "targets": [{"target": "admission.k8s.gatekeeper.sh",
                                  "rego": "package k8sclocky\n\n"
                                          'violation[{"msg": "tick"}] '
                                          "{ time.now_ns() > 0 }\n"}]}})
        port.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sClocky", "metadata": {"name": "clock"},
            "spec": {"match": {"kinds": [
                {"apiGroups": [""], "kinds": ["Pod"]}]}}})
        port.review(pod_request(syn.make_pods(1, seed=13)[0]))
        assert port.driver._memoable_synced() is False

    def test_hits_and_misses_equal_tpu_drivers(self):
        """One sequence of reviews and constraint changes: the port's
        request-memo probe outcomes equal TpuDriver's, and every answer
        equals the oracle's."""
        port, oracle, jax = _corpus_clients()
        counts = {"port": _spy_memo(port.driver),
                  "jax": _spy_memo(jax.driver)}
        pods = syn.make_pods(3, seed=21, violation_rate=0.7)
        kind = sorted(port.driver.constraints)[0]
        name = sorted(port.driver.constraints[kind])[0]
        base = copy.deepcopy(port.driver.constraints[kind][name])

        def review_all(tag, idx=(0, 1, 2, 0, 1)):
            for n, i in enumerate(idx):
                req = pod_request(pods[i], uid=f"{tag}-{n}")
                want = result_bytes(oracle.review(req).results())
                assert result_bytes(port.review(req).results()) == want
                assert result_bytes(jax.review(req).results()) == want

        def put(cons):
            for c in (port, oracle, jax):
                c.add_constraint(copy.deepcopy(cons))

        review_all("cold")
        changed = copy.deepcopy(base)
        changed["spec"]["enforcementAction"] = "dryrun"
        put(changed)
        review_all("changed")
        for c in (port, oracle, jax):
            c.remove_constraint(copy.deepcopy(changed))
        review_all("removed")
        put(base)
        batch = [pod_request(p, uid=f"b{i}") for i, p in enumerate(pods)]
        want = [result_bytes(r.results()) for r in oracle.review_batch(batch)]
        for c in (port, jax):
            assert [result_bytes(r.results())
                    for r in c.review_batch(batch)] == want
        assert counts["port"] == counts["jax"]
        assert counts["port"][0] > 0 and counts["port"][1] > 0

    def test_a_batch_past_the_bound_bypasses_the_memo(self):
        port, oracle, _jax = _corpus_clients()
        driver = port.driver
        n = driver.REQUEST_MEMO_BATCH_MAX + 1
        pods = syn.make_pods(n, seed=5, violation_rate=0.5)
        reqs = [pod_request(p, uid=f"s{i}") for i, p in enumerate(pods)]
        counts = _spy_memo(driver)
        got = [result_bytes(r.results()) for r in port.review_batch(reqs)]
        assert got == [result_bytes(r.results())
                       for r in oracle.review_batch(reqs)]
        assert counts == [0, 0] and not driver._request_memo
        assert not driver._review_memo  # a streaming chunk keys no cell
        # an admission-sized batch of the same pods probes and stores
        port.review_batch(reqs[:8])
        assert counts == [0, 8] and len(driver._request_memo) == 8

    def test_reset_and_template_changes_clear_the_memos(self):
        port, _oracle, _jax = _corpus_clients()
        driver = port.driver
        pod = syn.make_pods(1, seed=3, violation_rate=1.0)[0]
        port.review(pod_request(pod))
        assert driver._request_memo and driver._review_memo
        epoch = driver._cs_epoch
        kind = sorted(driver.templates)[0]
        driver.put_template(kind, driver.templates[kind])  # a re-ingest
        assert driver._cs_epoch == epoch + 1
        assert driver._cs_change_log[-1] == (epoch + 1, kind, None)
        counts = _spy_memo(driver)
        port.review(pod_request(pod))
        assert counts == [1, 0]  # repaired through the change log
        assert driver._review_memo_epoch == driver._cs_epoch
        driver.reset()
        assert not driver._request_memo and not driver._review_memo
        assert not driver._cs_change_log

    def test_request_memo_counter(self):
        port, _oracle, _jax = _corpus_clients(n=3)
        pod = syn.make_pods(1, seed=4, violation_rate=1.0)[0]
        rows = view("cache_requests_total")
        hit0 = rows.get(("request_memo", "hit"), 0.0)
        miss0 = rows.get(("request_memo", "miss"), 0.0)
        port.review(pod_request(pod, uid="one"))
        port.review(pod_request(pod, uid="two"))
        rows = view("cache_requests_total")
        assert rows[("request_memo", "miss")] == miss0 + 1
        assert rows[("request_memo", "hit")] == hit0 + 1
        from gatekeeper_tpu_torch.metrics.exporter import render_prometheus

        assert 'cache_requests_total{cache="request_memo",outcome="miss"}' \
            in render_prometheus()


# ---- the port's own: the status-only re-put --------------------------------


def test_a_status_only_reput_keeps_the_memo_and_a_real_change_misses():
    port, oracle, _jax = _corpus_clients()
    driver = port.driver
    pod = syn.make_pods(1, seed=13, violation_rate=1.0)[0]
    port.review(pod_request(pod, uid="a"))
    counts = _spy_memo(driver)
    kind = sorted(driver.constraints)[0]
    name = sorted(driver.constraints[kind])[0]
    written = copy.deepcopy(driver.constraints[kind][name])
    written["status"] = {"totalViolations": 7, "violations": []}
    written["metadata"]["resourceVersion"] = "99"
    epoch = driver._cs_epoch
    port.add_constraint(written)
    assert driver._cs_epoch == epoch and not driver._cs_change_log[epoch:]
    port.review(pod_request(pod, uid="b"))
    assert counts == [1, 0]
    assert driver._request_memo[next(iter(driver._request_memo))][0] == epoch
    # a real parameter change misses the stored entry: it is repaired,
    # its changed constraint evaluated again
    changed = copy.deepcopy(written)
    changed["spec"]["enforcementAction"] = "warn"
    port.add_constraint(changed)
    oracle.add_constraint(copy.deepcopy(changed))
    evaluated = []
    one = driver._eval_one_key
    driver._eval_one_key = lambda k, n, *a, **kw: evaluated.append((k, n)) \
        or one(k, n, *a, **kw)
    got = port.review(pod_request(pod, uid="c")).results()
    assert evaluated == [(kind, name)]
    assert result_bytes(got) == result_bytes(
        oracle.review(pod_request(pod, uid="c")).results())


# ---- the service model (tests/test_routing_load.py) -------------------------

LOAD_CAL = {
    # per-review service with 10 cells a review:
    #   interp: 10 ms a review       -> mu at B=256 =  100 rps
    #   np:     0.5 + 1 ms a review  -> mu at B=256 ~  998 rps
    #   device: 5 + 0.1 ms a review  -> mu at B=256 ~ 8366 rps
    # one review's latency: np 1.5 ms < device 5.1 ms < interp 10 ms
    "rtt_ms": 5.0,
    "device_cells_per_ms": 100.0,
    "interp_cells_per_ms": 1.0,
    "np_floor_ms": 0.5,
    "np_cells_per_ms": 10.0,
}
CELLS = 10  # one review x 10 constraints


def _driver_with(cal):
    drv = TorchDriver(device="cpu")
    drv._route_cal = dict(cal) if cal else None
    return drv


def _route(drv, cells=CELLS, n_reviews=1):
    """The pricing's (tier, reason) for a batch."""
    route, reason, _lam, _priced = drv._route_decision(cells, n_reviews)
    return route, reason


class TestServiceModel:
    def test_no_hint_routes_by_latency(self):
        assert _route(_driver_with(LOAD_CAL)) == ("np", "latency")

    def test_sustainable_load_is_load_aware(self):
        drv = _driver_with(LOAD_CAL)
        drv.set_offered_load(100.0)  # interp mu=100 < 100*1.25: excluded
        assert _route(drv) == ("np", "load_aware")
        drv.set_offered_load(2000.0)  # np mu ~998 < 2500: excluded
        assert _route(drv) == ("device", "load_aware")

    def test_saturation_drains_at_the_device(self):
        drv = _driver_with(LOAD_CAL)
        drv.set_offered_load(20000.0)  # above every tier's mu
        assert _route(drv) == ("device", "saturated")

    def test_stale_hint_expires(self):
        drv = _driver_with(LOAD_CAL)
        drv.set_offered_load(2000.0)
        rps, _t = drv._offered_load
        drv._offered_load = (rps, time.monotonic() - drv.LOAD_HINT_TTL_S - 1)
        assert drv._load_hint() is None
        assert _route(drv) == ("np", "latency")

    def test_clearing_the_hint_restores_latency_routing(self):
        drv = _driver_with(LOAD_CAL)
        drv.set_offered_load(20000.0)
        assert _route(drv) == ("device", "saturated")
        drv.set_offered_load(None)
        assert _route(drv) == ("np", "latency")
        drv.set_offered_load(0.0)  # zero load is no hint
        assert drv._offered_load is None

    def test_batch_size_scales_per_review_cells(self):
        """The load model prices per-review service: a 64-review batch
        of the same corpus must not look 64x heavier per review."""
        drv = _driver_with(LOAD_CAL)
        drv.set_offered_load(2000.0)
        assert _route(drv, CELLS * 64, 64) == ("device", "load_aware")
        _r, _why, lam, priced = drv._route_decision(CELLS * 64, 64)
        assert lam == 2000.0
        per_review = {p["tier"]: p["per_review_ms"] for p in priced}
        assert per_review == pytest.approx(
            {"device": CELLS / 100.0, "np": CELLS / 10.0,
             "interp": CELLS / 1.0})

    def test_none_without_calibration(self):
        """Uncalibrated, the priors decide: the interpreter below
        NP_MIN_CELLS cells, the numpy tier below DEVICE_MIN_CELLS, the
        device from it; the numpy tier off, the interpreter; a
        DEVICE_MIN_CELLS of 0 forces the device."""
        drv = _driver_with(None)
        assert drv.predicted_batch_ms(8) is None
        assert drv._tier_models(10) == []
        assert (drv.NP_MIN_CELLS, drv.DEVICE_MIN_CELLS) == (24, 4096)
        assert [_route(drv, c)[0] for c in (10, 24, 4095, 4096)] == [
            "interp", "np", "np", "device"]
        assert _route(drv) == ("interp", "uncalibrated_prior")
        drv.np_serve_enabled = False
        assert _route(drv, 100)[0] == "interp"
        drv.DEVICE_MIN_CELLS = 0
        assert _route(drv) == ("device", "forced_device")

    def test_affine_in_batch_size_and_equal_to_tpu_drivers(self):
        drv = _driver_with(LOAD_CAL)
        tpu = TpuDriver()
        tpu._route_cal = dict(LOAD_CAL)
        # every tier's model is TpuDriver's, number for number
        assert drv._tier_models(CELLS) == tpu._tier_models(CELLS)
        # an empty registry: one cell a review, the cheapest tier's time
        t1, t256 = drv.predicted_batch_ms(1), drv.predicted_batch_ms(256)
        assert t1 == pytest.approx(0.5 + 1 / 10.0)  # np
        assert t256 == pytest.approx(5.0 + 256 / 100.0)  # device
        xs = [drv.predicted_batch_ms(n) for n in (1, 4, 16, 64, 256)]
        assert xs == sorted(xs)
        assert xs == [tpu.predicted_batch_ms(n) for n in (1, 4, 16, 64, 256)]

    @pytest.mark.parametrize("pods,restored", [(40, False), (600, False),
                                               (600, True)])
    def test_calibration_fits_the_device_path(self, pods, restored):
        """calibrate_routing measures the three tiers on distinct objects,
        each evaluated once before in one warm-up on the device: the
        cache's when it holds the ones the runs take (its leaves frozen,
        or plain dicts as a snapshot's restore leaves them), else fresh
        pods.  The device: compute_masks and the render, at one and 128
        reviews; the numpy tier: _np_review at 1 and 8, one call more
        each; the interpreter: its walk of one review, then of five.
        No memo is read or fed, and the batcher's service model finds
        the calibrated model."""
        from gatekeeper_tpu_torch.engine.value import thaw

        client = syn.build_driver(4, pods, 0, device="cpu")
        driver = client.driver
        if restored:
            tree: dict = {}
            for obj, api, kind, name, ns in driver.store.iter_objects():
                path = ("namespace", ns, api, kind) if ns else (
                    "cluster", api, kind)
                node = tree
                for seg in path:
                    node = node.setdefault(seg, {})
                node[name] = thaw(obj)
            driver.store.adopt_tree(tree, leaves_frozen=False)
        sizes, names, renders, np_names, walks = [], [], [], [], []
        orig = driver.compute_masks
        orig_render = driver._render_masked
        orig_np = driver._np_review
        orig_walk = driver._interp_review_memo

        def masks(rs):
            sizes.append(len(rs))
            names.extend(r["name"] for r in rs)
            return orig(rs)

        def render(reviews, *a, **kw):
            renders.append((len(reviews), kw.get("memo")))
            return orig_render(reviews, *a, **kw)

        def np_review(reviews, *a, **kw):
            np_names.append([r["name"] for r in reviews])
            return orig_np(reviews, *a, **kw)

        def walk(review, *a, **kw):
            walks.append((review["name"], kw.get("memo")))
            return orig_walk(review, *a, **kw)

        driver.compute_masks = masks
        driver._render_masked = render
        driver._np_review = np_review
        driver._interp_review_memo = walk
        mb = MicroBatcher(client)
        try:
            assert mb._service_model()[0](8) is None  # not yet calibrated
            cal = driver.calibrate_routing(runs=2)
        finally:
            mb.stop()
        assert set(cal) == {"rtt_ms", "device_cells_per_ms", "np_floor_ms",
                            "np_cells_per_ms", "interp_cells_per_ms"}
        assert all(v > 0 for v in cal.values())
        # one warm-up of every object, then the device's runs at 1 and
        # 128, the numpy tier's at 1 and 8, the interpreter's walks
        n_dev, n_np, n_walk = 2 * (1 + 128), 3 * (1 + 8), 1 + 5
        pool = n_dev + n_np + n_walk
        assert sizes == [pool] + [1] * 2 + [128] * 2
        warm, timed = names[:pool], names[pool:]
        assert len(set(warm)) == pool and timed == warm[:n_dev]
        assert [len(b) for b in np_names] == [1] * 3 + [8] * 3
        assert sum(np_names, []) == warm[n_dev:n_dev + n_np]
        assert walks == [(n, False) for n in warm[n_dev + n_np:]]
        stored = {name for _o, _a, _k, name, _ns
                  in driver.store.iter_objects()}
        if pods >= pool:
            assert set(warm) <= stored
        else:
            assert not set(warm) & stored
        # keys no memo: every render of the device's and the numpy tier's
        assert renders == [(n, False) for n in sizes + [1] * 3 + [8] * 3]
        predict, set_load = mb._service_model()
        assert predict(8) == pytest.approx(min(
            cal["rtt_ms"] + 8 * 4 / cal["device_cells_per_ms"],
            cal["np_floor_ms"] + 8 * 4 / cal["np_cells_per_ms"],
            8 * 4 / cal["interp_cells_per_ms"]))
        set_load(50.0)
        assert driver._load_hint() == 50.0
        # nothing of it is memoized
        assert not driver._request_memo and not driver._review_memo
        assert TorchDriver(device="cpu").calibrate_routing() is None
        # the numpy tier off: the device and the interpreter alone
        driver.np_serve_enabled = False
        assert set(driver.calibrate_routing(runs=1)) == {
            "rtt_ms", "device_cells_per_ms", "interp_cells_per_ms"}


# ---- the route ledger (tests/test_routeledger.py TestDriverRecording) -------


def _ledger_client(n=3):
    templates, constraints = syn.make_templates(n)
    c = Client(driver=TorchDriver(device="cpu"))
    for t, k in zip(templates, constraints):
        c.add_template(t)
        c.add_constraint(k)
    return c


def _ledger_review(i=0):
    return {
        "uid": f"u{i}",
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "name": f"pod-{i}", "namespace": "default",
        "operation": "CREATE",
        "object": {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"pod-{i}", "namespace": "default",
                         "labels": {"i": str(i)}},
            "spec": {"containers": [{"name": "c",
                                     "image": f"img.io/x:{i}"}]},
        },
    }


def _entries(d):
    return d.route_ledger.snapshot()["decisions"]


class TestDriverRecording:
    def test_a_review_batch_records_one_entry_with_its_reason(self):
        """Uncalibrated, the priors price each batch by its cells: 9 go
        to the interpreter, 24 (NP_MIN_CELLS) to the numpy tier, and past
        DEVICE_MIN_CELLS to the device; each batch one entry, under the
        tier that served it, and memo hits none."""
        c = _ledger_client()
        d = c.driver
        d.route_ledger.clear()
        c.review_batch([_ledger_review(i) for i in range(3)])
        c.review_batch([_ledger_review(i) for i in range(10, 18)])
        d.DEVICE_MIN_CELLS = 30
        c.review_batch([_ledger_review(i) for i in range(20, 30)])
        assert [(e["tier"], e["reason"], e["n_reviews"], e["cells"])
                for e in _entries(d)] == [
                    ("interp", "uncalibrated_prior", 3, 9),
                    ("np", "uncalibrated_prior", 8, 24),
                    ("device", "uncalibrated_prior", 10, 30)]
        c.review_batch([_ledger_review(i) for i in range(3)])  # memo hits
        assert len(_entries(d)) == 3

    def test_calibrated_decision_carries_priced_table(self):
        c = _ledger_client()
        d = c.driver
        d._route_cal = {
            "rtt_ms": 5.0, "device_cells_per_ms": 100.0,
            "interp_cells_per_ms": 10.0,
            "np_floor_ms": 1.0, "np_cells_per_ms": 50.0,
        }
        d.route_ledger.clear()
        c.review_batch([_ledger_review(i) for i in range(4)])
        entry = _entries(d)[-1]
        # 12 cells: interp 1.2 ms, np 1.24, device 5.12
        assert (entry["tier"], entry["reason"]) == ("interp", "latency")
        priced = {p["tier"]: p for p in entry["priced"]}
        assert set(priced) == {"interp", "device", "np"}
        assert all(p["mu_rps"] > 0 for p in priced.values())
        assert {t: p["predicted_ms"] for t, p in priced.items()} == \
            pytest.approx({"interp": 1.2, "np": 1.24, "device": 5.12})

    def test_brownout_pin_reason(self):
        c = _ledger_client()
        d = c.driver
        d._route_cal = {"rtt_ms": 5.0, "device_cells_per_ms": 100.0,
                        "interp_cells_per_ms": 10.0}
        d.set_brownout_pin(True)
        d.route_ledger.clear()
        c.review(_ledger_review(9))
        assert _entries(d)[-1]["reason"] == "brownout_pin"
        # the tier of most throughput at 256 reviews: the device
        assert d.route_ledger.last() == ("device", "brownout_pin")
        d.set_brownout_pin(False)

    def test_breaker_open_override_recorded(self):
        c = _ledger_client()
        d = c.driver
        d.DEVICE_MIN_CELLS = 0  # the price says the device, always
        d.route_ledger.clear()
        d.breaker.trip()
        try:
            assert c.review(_ledger_review(1)) is not None
            entry = _entries(d)[-1]
            assert (entry["tier"], entry["reason"]) == (
                "np", "breaker_open")
            # the numpy tier off: the interpreter serves
            d.np_serve_enabled = False
            assert c.review(_ledger_review(2)) is not None
            assert d.route_ledger.last() == ("interp", "breaker_open")
        finally:
            d.breaker.record_success()

    def test_device_failure_records_amended_decision(self):
        c = _ledger_client()
        d = c.driver
        d.DEVICE_MIN_CELLS = 0
        c.review(_ledger_review(0))
        d.route_ledger.clear()
        plane = faults.install(seed=3)
        plane.add(faults.TPU_DISPATCH,
                  FaultRule(mode=faults.ERROR, probability=1.0, count=1))
        try:
            assert c.review(_ledger_review(2)) is not None
        finally:
            faults.uninstall()
        assert [(e["tier"], e["reason"]) for e in _entries(d)] == [
            ("device", "forced_device"), ("np", "device_failed")]

    def test_a_failed_batch_past_its_deadline_raises(self):
        c = _ledger_client()
        d = c.driver
        d.DEVICE_MIN_CELLS = 0
        plane = faults.install(seed=3)
        plane.add(faults.TPU_DISPATCH, FaultRule(mode=faults.ERROR))
        token = tdeadline.push(0.0)
        try:
            with pytest.raises(tdeadline.DeadlineExceeded):
                d.review_batch([_ledger_review(4)])
        finally:
            tdeadline.pop(token)
            faults.uninstall()

    def test_routez_serves_the_active_driver(self):
        c = _ledger_client()
        d = c.driver
        d.route_ledger.clear()
        c.review_batch([_ledger_review(i) for i in range(7)])
        code, ctype, body = get_router().handle("/debug/routez", "limit=5")
        assert code == 200 and ctype == "application/json"
        payload = json.loads(body)
        assert payload["decisions"][-1]["cells"] == 21
        assert payload["calibration"] is None
        d._route_cal = {"rtt_ms": 5.0, "device_cells_per_ms": 100.0,
                        "interp_cells_per_ms": 10.0,
                        "np_floor_ms": 1.0, "np_cells_per_ms": 50.0}
        payload = json.loads(get_router().handle("/debug/routez")[2])
        assert payload["calibration"]["rtt_ms"] == 5.0
        assert set(payload["curves_ms_per_review"]["10"]) == {
            "device", "np", "interp"}



# ---- the card keeps its batches (price_host_tiers) -------------------------

RESIDENT_CASES = {
    # (calibration, brownout pin, reviews in the batch) -> the tier the
    # pricing chooses for 3 constraints
    "prior_interp": (None, False, 3),  # 9 cells: the interpreter
    "prior_np": (None, False, 8),  # 24 cells: the numpy tier
    "latency_np": (LOAD_CAL, False, 1),
    "brownout_np": ({**LOAD_CAL, "rtt_ms": 500.0}, True, 1),
}


@pytest.mark.parametrize("case", sorted(RESIDENT_CASES))
def test_on_the_card_a_host_priced_batch_is_served_by_the_device(case):
    """Without price_host_tiers (a driver on the card), a batch the
    pricing sends to a host tier is served by the device: compute_masks
    runs, the ledger names the device with reason device_resident and
    keeps the priced table, and the answers are those of the host tier a
    twin with price_host_tiers serves.  The breaker's divert still goes
    to the numpy tier, and the batcher's model prices the device alone."""
    cal, pin, n = RESIDENT_CASES[case]
    card, host = _ledger_client(), _ledger_client()
    card.driver.price_host_tiers = False
    calls = []
    orig = card.driver.compute_masks

    def masks(reviews):
        calls.append(len(reviews))
        return orig(reviews)

    card.driver.compute_masks = masks
    for c in (card, host):
        c.driver._route_cal = dict(cal) if cal else None
        c.driver.set_brownout_pin(pin)
    batch = [_ledger_review(i) for i in range(40, 40 + n)]
    want = host.review_batch(copy.deepcopy(batch))
    assert host.driver.route_ledger.last()[0] in ("np", "interp")
    got = card.review_batch(copy.deepcopy(batch))
    assert calls == [n]
    entry = _entries(card.driver)[-1]
    assert (entry["tier"], entry["reason"]) == ("device", "device_resident")
    assert ("priced" in entry) == (cal is not None)
    assert [result_bytes(r.results()) for r in got] == \
        [result_bytes(r.results()) for r in want]
    if cal is not None:
        rtt, per = cal["rtt_ms"], 3 / cal["device_cells_per_ms"]
        assert card.driver.predicted_batch_ms(8) == pytest.approx(
            rtt + 8 * per)
        assert host.driver.predicted_batch_ms(1) < rtt
    card.driver.breaker.trip()
    try:
        card.review(_ledger_review(90))
        assert card.driver.route_ledger.last() == ("np", "breaker_open")
        assert calls == [n]
    finally:
        card.driver.breaker.record_success()


def test_price_host_tiers_is_off_on_the_card(monkeypatch):
    """price_host_tiers is true for a driver on the CPU and false for one
    on the card (its device and kernel load stood in for here)."""
    import torch

    from gatekeeper_tpu_torch.ops import driver as drvmod

    assert TorchDriver(device="cpu").price_host_tiers is True
    monkeypatch.setattr(drvmod, "select_device",
                        lambda _d: torch.device("cuda"))
    monkeypatch.setattr(drvmod, "kernels", lambda: None)
    monkeypatch.setenv("GK_MESH", "0")
    assert TorchDriver(device="cuda").price_host_tiers is False


# ---- the adaptive batcher on the port's driver (tests/test_fleet.py) --------


def _equilibrium(driver, lam, max_batch=256):
    lam_pms = lam / 1e3
    b = 1.0
    for _ in range(4):
        t = driver.predicted_batch_ms(max(int(b), 1))
        nb = min(max(lam_pms * t, 1.0), float(max_batch))
        if abs(nb - b) < 0.5:
            return nb
        b = nb
    return b


class TestAdaptiveBatcher:
    # the device 0.05 ms a review, the cheapest tier at every batch size
    CAL = {"rtt_ms": 0.2, "device_cells_per_ms": 20.0,
           "interp_cells_per_ms": 1.0}

    def _batcher(self, cal=CAL, **kw):
        client = Client(driver=_driver_with(cal))
        return MicroBatcher(client, window_s=0.002, **kw)

    def test_low_load_targets_immediate_dispatch(self):
        mb = self._batcher()
        try:
            with mb._rate_lock:
                mb._load_rps = 50.0
            assert mb._adapt() == (1, 0.0)
        finally:
            mb.stop()

    def test_high_load_grows_target_and_pushes_the_hint(self):
        mb = self._batcher()
        drv = mb._client.driver
        try:
            with mb._rate_lock:
                mb._load_rps = 20000.0
            target, deadline = mb._adapt()
            want = _equilibrium(drv, 20000.0)
            assert target == max(int(round(want)), 1) and target > 1
            assert 0.0 < deadline <= mb.max_deadline_s
            assert drv._load_hint() == 20000.0
        finally:
            mb.stop()

    def test_extreme_load_caps_at_max_batch_and_deadline(self):
        mb = self._batcher(max_deadline_s=0.010)
        try:
            with mb._rate_lock:
                mb._load_rps = 1e9
            target, deadline = mb._adapt()
            assert target == mb.max_batch and deadline <= 0.010
        finally:
            mb.stop()

    def test_static_mode_never_adapts(self):
        mb = self._batcher(adaptive=False)
        try:
            with mb._rate_lock:
                mb._load_rps = 1e6
            assert mb._adapt() == (1, 0.0)
            assert mb._client.driver._offered_load is None
        finally:
            mb.stop()

    def test_no_calibration_stays_dormant(self):
        mb = self._batcher(cal=None)
        try:
            with mb._rate_lock:
                mb._load_rps = 1e6
            assert mb._adapt() == (1, 0.0)
        finally:
            mb.stop()

    def test_model_failure_never_stalls_dispatch(self, monkeypatch):
        mb = self._batcher()

        def broke(n):
            raise RuntimeError("model broke")

        monkeypatch.setattr(mb._client.driver, "predicted_batch_ms", broke)
        try:
            with mb._rate_lock:
                mb._load_rps = 1e6
            assert mb._adapt() == (1, 0.0)
        finally:
            mb.stop()

    def test_idle_gap_resets_rate_outright(self):
        mb = self._batcher()
        try:
            with mb._rate_lock:
                mb._load_rps = 50000.0
                mb._arrivals = 1
                mb._rate_t0 = time.monotonic() - (mb.IDLE_RESET_S + 1.0)
            assert mb.offered_load_rps() < 1.0
            assert mb._adapt() == (1, 0.0)
        finally:
            mb.stop()

    def test_short_bucket_blends_ewma(self):
        mb = self._batcher()
        try:
            with mb._rate_lock:
                mb._load_rps = 1000.0
                mb._arrivals = 500
                mb._rate_t0 = time.monotonic() - 0.5
            assert 900.0 < mb.offered_load_rps() < 1100.0
        finally:
            mb.stop()

    def test_adaptive_window_clamped_to_member_deadline(self, monkeypatch):
        mb = self._batcher()
        try:
            # the batch dispatches DEADLINE_CLAMP_MARGIN_S before the
            # budget ends: the request is a memo hit, which answers
            # inside that margin; the margin is widened past a loaded
            # host's thread wake-up, which the 2 ms default is not
            mb._client.review(_ledger_review(3))
            monkeypatch.setattr(mb, "DEADLINE_CLAMP_MARGIN_S", 0.25)
            monkeypatch.setattr(mb, "_adapt", lambda: (64, 10.0))
            token = tdeadline.push(1.0)  # a budget far below the window
            try:
                t0 = time.monotonic()
                mb.review(_ledger_review(3))
                waited = time.monotonic() - t0
            finally:
                tdeadline.pop(token)
            assert waited < 2.0
        finally:
            mb.stop()

    def test_stop_clears_the_driver_load_hint(self):
        mb = self._batcher()
        drv = mb._client.driver
        with mb._rate_lock:
            mb._load_rps = 5000.0
        mb._adapt()
        assert drv._offered_load is not None
        mb.stop()
        assert drv._offered_load is None


# ---- the process: flags, calibration, a divert on /healthz ------------------

APP_FLAGS = [
    "--torch-device", "cpu", "--port", "0", "--prometheus-port", "0",
    "--health-addr", ":0", "--audit-interval", "3600",
    "--log-level", "WARNING",
]


def _app(tmp_path, *flags):
    args = build_parser().parse_args(
        APP_FLAGS + ["--cert-dir", str(tmp_path)] + list(flags))
    return App(args, kube=InMemoryKube())


def _tls():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def _get(app, path):
    try:
        with urllib.request.urlopen(
            f"https://127.0.0.1:{app.webhook_server.port}{path}",
            context=_tls(), timeout=5,
        ) as r:
            return r.status, r.read()
    except Exception:
        return None, b""


def test_the_app_takes_the_breaker_flags(tmp_path):
    app = _app(tmp_path, "--breaker-failure-threshold", "5",
               "--breaker-cooldown-s", "7.5", "--slo-trip-breaker")
    breaker = app.client.driver.breaker
    assert breaker.failure_threshold == 5 and breaker.cooldown_s == 7.5
    defaults = _app(tmp_path).client.driver.breaker
    assert defaults.failure_threshold == 3 and defaults.cooldown_s == 5.0
    from gatekeeper_tpu_torch.obs import slo as obsslo

    engine = obsslo.get_engine()
    app.start()
    try:
        assert engine._on_alert, "the App registered no SLO alert hook"
        for hook in list(engine._on_alert):
            hook(obsslo.ADMISSION_LATENCY, "fast")
        assert breaker.state == OPEN
    finally:
        app.stop()
        breaker.record_success()


def test_a_device_failure_is_counted_and_reads_degraded(tmp_path):
    """A divert lands in route_decisions_total under its reason, the
    answer equals the oracle's, and /healthz reads degraded while the
    breaker is not closed; the App calibrates its driver in the
    background and the batcher finds the model."""
    app = _app(tmp_path, "--breaker-failure-threshold", "1",
               "--breaker-cooldown-s", "60")
    driver = app.client.driver
    app.start()
    try:
        app.client.add_template(TEMPLATE)
        app.client.add_constraint(CONSTRAINT)
        assert wait_until(lambda: _get(app, "/healthz") == (200, b"ok"),
                          timeout_s=30)
        assert wait_until(lambda: driver._route_cal is not None,
                          timeout_s=60), "the App never calibrated"
        predict, _set = app.micro_batcher._service_model()
        assert predict(8) == driver.predicted_batch_ms(8) is not None
        assert set(driver._route_cal) == {
            "rtt_ms", "device_cells_per_ms", "np_floor_ms",
            "np_cells_per_ms", "interp_cells_per_ms"}
        driver.DEVICE_MIN_CELLS = 0  # the review below tries the device
        oracle = oracle_client()
        before = route_count("np", "device_failed")
        plane = faults.install(seed=5)
        plane.add(faults.TPU_DISPATCH, FaultRule(mode="error"))
        try:
            req = ns_review("diverted")
            got = app.client.review(AugmentedReview(admission_request=req))
        finally:
            faults.uninstall()
        assert result_bytes(got.results()) == result_bytes(
            oracle.review(AugmentedReview(admission_request=req)).results())
        assert route_count("np", "device_failed") == before + 1
        assert driver.breaker.state == OPEN
        assert _get(app, "/healthz") == (200, b"ok (degraded)")
        assert driver.breaker.probe_now()
        assert _get(app, "/healthz") == (200, b"ok")
    finally:
        app.stop()


# ---- C1: a join divergence is recorded with the assertion off --------------


def test_a_join_divergence_is_recorded_with_the_assertion_off(monkeypatch):
    monkeypatch.delenv("GK_JOIN_ASSERT", raising=False)
    before = float(view("join_plan_divergence_total").get(()) or 0.0)
    joinkernel.note_false_positive("K8sUniqueHost", "c0", 4)
    assert view("join_plan_divergence_total").get(()) == before + 1
    monkeypatch.setenv("GK_JOIN_ASSERT", "1")
    with pytest.raises(joinkernel.JoinDivergence):
        joinkernel.note_false_positive("K8sUniqueHost", "c0", 4)
    assert view("join_plan_divergence_total").get(()) == before + 2
