"""The port's fleet on the CPU: webhook replicas (``python -m
gatekeeper_tpu_torch.fleet.replica --torch-device cpu``) that restore one
sealed snapshot a port App wrote, behind the port's two front doors.

A port App (``--torch-device cpu --snapshot-dir``) over an in-memory store
holding four namespaces, a Config syncing Pods, 12 synthetic templates
with their constraints and 300 pods cycles once and writes one snapshot.
``spawn_fleet(2)`` restores it (``--snapshot-no-resync``, into empty
stores).  24 unique pod admissions, about half of them violating, go to
each replica directly, through the threaded ``FrontDoor`` and through the
``EventFrontDoor`` (framed chunks to each replica's ``WireListener``).

The comparison: every response body is byte-identical across the
replicas and the two doors; each verdict, and each denial's violation
messages with the webhook's ``[denied by ...]`` prefix stripped, are
byte-equal to the ``InterpDriver`` oracle's and equal to the JAX
package's ``TpuDriver`` (CPU JAX backend, ``DEVICE_MIN_CELLS = 0`` so its
device path serves) over the same templates, constraints and pods.  No
JAX replica is spawned: the JAX package is held in this process.  The
tolerance is zero.

Also: a ``ReplicaSupervisor`` respawns a SIGKILLed replica warm and it
answers the same; ``drain`` replies ``drained``; a replica spawned without
``--torch-device cpu`` does not start on a host without a card (no
fallback); a request with a ``traceparent`` through the door joins the
door's wire stages with the replica's admission trace, which holds
``TorchDriver``'s pack and dispatch stages; a saturation burst against
one replica with a small pending bound answers only accepted, shed or
expired, every accepted verdict the oracle's."""

import copy
import http.client
import json
import os
import shutil
import tempfile
import threading
import time

import pytest
import torch

from gatekeeper_tpu.client.client import Client as JaxClient
from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.client.drivers import InterpDriver
from gatekeeper_tpu_torch.fleet import (
    EventFrontDoor,
    FrontDoor,
    ReplicaSupervisor,
    spawn_fleet,
    spawn_replica,
)
from gatekeeper_tpu_torch.fleet.frontdoor import WIRE_STAGES
from gatekeeper_tpu_torch.fleet.replica import _child_parser
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.main import App, build_parser
from gatekeeper_tpu_torch.obs import trace as obstrace
from gatekeeper_tpu_torch.obs.fleetobs import TraceCollector
from gatekeeper_tpu_torch.util import overloadcheck
from gatekeeper_tpu_torch.util import synthetic as syn

N_TEMPLATES, N_PODS, N_REQUESTS = 12, 300, 24
NAMESPACES = ("ns-0", "ns-1", "ns-2", "ns-3")
SEED_TEMPLATES, SEED_PODS, SEED_REQUESTS = 31, 32, 33
MAX_PENDING = 4  # the replicas' batcher bound: the burst must overrun it
CPU = ["--torch-device", "cpu", "--webhook-max-pending", str(MAX_PENDING)]
SPAWN_S = 90.0  # each spawn's own limit
# one intra-op thread a replica: the tests beside this file keep the cores;
# the device path serves every admission, as TpuDriver's does below
ENV = {"OMP_NUM_THREADS": "1", "GK_DEVICE_MIN_CELLS": "0"}
HTTP_S = 30.0


def _store():
    kube = InMemoryKube()
    for ns in NAMESPACES:
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": ns}})
    kube.create({
        "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {"sync": {"syncOnly": [
            {"group": "", "version": "v1", "kind": "Pod"}]}},
    })
    templates, constraints = syn.make_templates(N_TEMPLATES, SEED_TEMPLATES)
    pods = syn.make_pods(N_PODS, SEED_PODS)
    for i, p in enumerate(pods):
        p["metadata"]["namespace"] = NAMESPACES[i % len(NAMESPACES)]
    for o in templates + constraints + pods:
        kube.create(o)
    return kube, templates + constraints + pods


def _write_snapshot(kube, root: str) -> str:
    """One port App cycles over the store and writes one snapshot."""
    snap = os.path.join(root, "snap")
    args = build_parser().parse_args([
        "--torch-device", "cpu", "--snapshot-dir", snap,
        "--snapshot-interval", "86400", "--cert-dir",
        os.path.join(root, "certs"), "--port", "0", "--prometheus-port",
        "0", "--health-addr", ":0", "--audit-from-cache",
        "--audit-interval", "3600", "--log-level", "WARNING",
    ])
    app = App(args, kube=kube)
    app.start()
    try:
        app.snapshotter.stop()
        deadline = time.monotonic() + 60
        while not (len(app.client.templates()) == N_TEMPLATES
                   and _held_pods(app) == N_PODS
                   and app.manager.drain(timeout=5)):
            assert time.monotonic() < deadline, "the App never synced"
            time.sleep(0.01)
        assert app.audit_manager.run_once_guarded()
        assert app.snapshotter.write_once() is not None
    finally:
        app.stop()
    return snap


def _held_pods(app) -> int:
    store = app.client.driver.store
    with store._lock:
        spaces = store.tree.get("namespace") or {}
        return sum(len((gv.get("v1") or {}).get("Pod") or {})
                   for gv in spaces.values())


def _loaded(client, objs):
    """``client`` holding the store's templates, constraints and pods."""
    for kind in ("ConstraintTemplate", None, "Pod"):
        for obj in objs:
            if kind is None and obj["apiVersion"].startswith(
                    "constraints.gatekeeper.sh/"):
                client.add_constraint(obj)
            elif obj["kind"] == kind == "ConstraintTemplate":
                client.add_template(obj)
            elif obj["kind"] == kind == "Pod":
                client.add_data(obj)
    return client


def _requests():
    pods = syn.make_pods(N_REQUESTS, SEED_REQUESTS, violation_rate=0.5)
    out = []
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"fleet-{i}"
        p["metadata"]["namespace"] = NAMESPACES[i % len(NAMESPACES)]
        out.append({
            "uid": f"fleet-{i}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": p["metadata"]["name"],
            "namespace": p["metadata"]["namespace"],
            "operation": "CREATE",
            "userInfo": {"username": "fleet-test"},
            "object": p,
        })
    return out


def _verdicts(client, reqs):
    """(allowed, sorted violation messages) per request."""
    out = []
    for req in reqs:
        results = client.review(
            {k: req[k] for k in
             ("kind", "name", "namespace", "operation", "object")}
        ).results()
        out.append((not results, sorted(r.msg for r in results)))
    return out


def _post(port: int, body: bytes, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_S)
    try:
        conn.request("POST", "/v1/admit", body=body, headers={
            "Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def fleet():
    root = tempfile.mkdtemp(prefix="gk-torch-fleet-")
    handles = []
    try:
        kube, objs = _store()
        snap = _write_snapshot(kube, root)
        cache = os.path.join(root, "cache")
        handles = spawn_fleet(2, snapshot_dir=snap, cache_dir=cache,
                              extra_flags=CPU, env=ENV, timeout_s=SPAWN_S,
                              sequential=False)
        reqs = _requests()
        bodies = [json.dumps({"request": r}).encode() for r in reqs]
        direct = {}
        for h in handles:
            direct[h.replica_id] = []
            for body in bodies:
                st, _hd, data = _post(h.port, body)
                assert st == 200, (h.replica_id, st, data[:200])
                direct[h.replica_id].append(data)
        yield {"root": root, "snap": snap, "cache": cache,
               "handles": handles, "objs": objs, "reqs": reqs,
               "bodies": bodies, "direct": direct}
    finally:
        for h in handles:
            h.stop()
        shutil.rmtree(root, ignore_errors=True)


def test_the_replica_defaults_to_the_torch_driver_on_the_card():
    args = _child_parser().parse_args(["--replica-id", "r"])
    assert (args.driver, args.torch_device) == ("torch", "cuda")
    with pytest.raises(SystemExit):
        _child_parser().parse_args(["--replica-id", "r", "--driver", "tpu"])


@pytest.mark.parametrize("flag", [[], ["--brownout-disable"]])
def test_the_replica_passes_brownout_disable_to_the_app(monkeypatch, flag):
    """The replica's App gets --brownout-disable exactly when the replica
    was given it (the ladder on by default, as in the App)."""
    import gatekeeper_tpu_torch.main as gkmain
    from gatekeeper_tpu_torch.fleet import replica

    seen = []

    class Stop(Exception):
        pass

    def app(args, kube=None):
        seen.append(args)
        raise Stop

    monkeypatch.setattr(gkmain, "App", app)
    with pytest.raises(Stop):
        replica.main(["--replica-id", "r", "--torch-device", "cpu"] + flag)
    assert seen[0].brownout_disable is bool(flag)


def test_every_replica_restores_the_apps_snapshot(fleet):
    for h in fleet["handles"]:
        assert h.ready["restore_outcome"] == "restored", h.ready
        assert h.ready["templates"] == N_TEMPLATES
        assert h.ready["namespaces_seeded"] == len(NAMESPACES)
        assert h.wire_port and h.metrics_port


def test_bodies_are_byte_identical_across_replicas_and_doors(fleet):
    handles, bodies = fleet["handles"], fleet["bodies"]
    want = fleet["direct"][handles[0].replica_id]
    for h in handles[1:]:
        assert fleet["direct"][h.replica_id] == want, h.replica_id
    ids = {h.replica_id for h in handles}
    threaded = FrontDoor([h.backend() for h in handles]).start()
    evdoor = EventFrontDoor([h.wire_backend() for h in handles]).start()
    try:
        for door in (threaded, evdoor):
            seen = set()
            for i, body in enumerate(bodies):
                st, hd, data = _post(door.port, body)
                assert st == 200, (type(door).__name__, i, data[:200])
                assert data == want[i], (type(door).__name__, i)
                assert hd.get("X-GK-Replica") in ids
                seen.add(hd["X-GK-Replica"])
            assert seen == ids, (type(door).__name__, seen)
    finally:
        evdoor.stop()
        threaded.stop()


def test_verdicts_equal_the_oracle_and_the_jax_driver(fleet):
    reqs = fleet["reqs"]
    tpu = TpuDriver()
    tpu.DEVICE_MIN_CELLS = 0  # its device path serves every review
    jax_client = _loaded(JaxClient(driver=tpu), fleet["objs"])
    want = _verdicts(_loaded(Client(driver=InterpDriver()),
                             fleet["objs"]), reqs)
    assert _verdicts(jax_client, reqs) == want
    assert any(a for a, _m in want) and not all(a for a, _m in want)
    for rid, bodies in fleet["direct"].items():
        for i, data in enumerate(bodies):
            out = json.loads(data)["response"]
            assert overloadcheck.verdict_matches(out, want[i]), (rid, i)


def test_a_replica_without_the_cpu_flag_does_not_start_without_a_card(
        fleet):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card") as err:
        spawn_replica("nocard", fleet["snap"], fleet["cache"], env=ENV,
                      timeout_s=SPAWN_S)
    assert "exited rc=" in str(err.value)


def test_torch_driver_records_the_review_stages():
    """The review's pack and dispatch as spans under the active trace and
    as the stage histograms, with TpuDriver's names and attributes."""
    from gatekeeper_tpu_torch.metrics.catalog import _global

    client = syn.build_driver(3, 40, device="cpu")
    reviews = [client.target.handle_review(p)[1]
               for p in syn.make_pods(5, 9, violation_rate=0.5)]
    before = {
        name: _global().view_rows(name)
        for name in ("tpu_pack_seconds", "tpu_dispatch_seconds")
    }
    with obstrace.root_span("stage-test") as root:
        client.driver.compute_masks(reviews)
        tid = root.trace.trace_id
    spans = [s for t in obstrace.get_tracer().traces()
             if t["trace_id"] == tid for s in t["spans"]]
    by_name = {s["name"]: s.get("attrs", {}) for s in spans}
    assert by_name["tpu.pack"]["stage"] == obstrace.PACK
    assert by_name["tpu.pack"]["reviews"] == 5
    assert by_name["tpu.dispatch"]["stage"] == obstrace.DISPATCH
    assert by_name["tpu.dispatch"]["tier"] == "torch"
    assert by_name["tpu.dispatch"]["rows"] >= 5
    assert by_name["tpu.dispatch"]["breaker"] == "closed"
    for name, tags in (("tpu_pack_seconds", ("review",)),
                       ("tpu_dispatch_seconds", ("review", "torch"))):
        rows = _global().view_rows(name)
        n_before = getattr(before[name].get(tags), "count", 0)
        assert rows[tags].count == n_before + 1, (name, rows)


def test_one_trace_joins_the_door_and_the_replica(fleet):
    handles = fleet["handles"]
    door = FrontDoor([h.backend() for h in handles],
                     probe_interval_s=3600.0).start()
    try:
        tid = "4bf92f3577b34da6a3ce929d0e0e4736"
        # a pod no replica has answered: a repeat replays from the
        # request memo, which packs and dispatches nothing
        body = json.dumps({"request": _fresh(fleet["reqs"], 0,
                                             "trace")}).encode()
        st, hd, _data = _post(door.port, body, {
            "traceparent": f"00-{tid}-00f067aa0ba902b7-01"})
        assert st == 200 and hd["X-GK-Trace-Id"] == tid
        rid = hd["X-GK-Replica"]
        col = TraceCollector(lambda: [
            {"replica_id": h.replica_id, "host": h.host, "port": h.port}
            for h in handles])
        entry = None
        deadline = time.monotonic() + 15
        while entry is None and time.monotonic() < deadline:
            entry = next((t for t in col.assemble()["traces"]
                          if t["trace_id"] == tid
                          and len(t["processes"]) > 1), None)
            time.sleep(0.05)
        assert entry is not None, "the replica half never joined"

        def stages(process):
            return {(s.get("attrs") or {}).get("stage")
                    for s in entry["spans"]
                    if s.get("process") == process} - {None}

        assert stages("frontdoor") and stages("frontdoor") <= set(
            WIRE_STAGES)
        assert {obstrace.PACK, obstrace.DISPATCH} <= stages(rid)
        dispatch = [s for s in entry["spans"] if s.get("process") == rid
                    and s["name"] == "tpu.dispatch"]
        assert dispatch and dispatch[0]["attrs"]["tier"] == "torch"
    finally:
        door.stop()


def _fresh(reqs, n: int, tag: str) -> dict:
    """Request ``n`` of a pass: request n of ``reqs`` under a name of its
    own, so no replica has answered it (its request memo holds none)."""
    req = copy.deepcopy(reqs[n % len(reqs)])
    name = f"{tag}-{n}"
    req["uid"] = req["name"] = req["object"]["metadata"]["name"] = name
    return req


def test_a_saturation_burst_sheds_and_never_diverges(fleet):
    """Every request of the burst is a pod the replica has not seen, so
    each one evaluates (a repeat would replay from the request memo,
    outside the driver's lock); each accepted answer carries the
    oracle's verdict and equals the other replica's direct answer."""
    h = fleet["handles"][0]
    reqs = fleet["reqs"]
    results, lock = [], threading.Lock()
    stop = time.monotonic() + 1.5
    n_clients = 12

    def slam(tid):
        i = tid
        while time.monotonic() < stop:
            idx = i
            i += n_clients
            body = json.dumps({"request": _fresh(reqs, idx, "burst")})
            try:
                st, _hd, data = _post(h.port, body.encode())
            except OSError:
                st, data = 0, b""
            kind, out = overloadcheck.classify_response(st, data)
            with lock:
                results.append((kind, out, idx))

    threads = [threading.Thread(target=slam, args=(t,))
               for t in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a burst client hung"
    kinds = [k for k, _o, _i in results]
    assert kinds and overloadcheck.PROBLEM not in kinds, results[:3]
    # the bound engaged, and the replica still served
    assert overloadcheck.SHED in kinds and overloadcheck.ACCEPTED in kinds
    oracle = _loaded(Client(driver=InterpDriver()), fleet["objs"])
    accepted = [(out, idx) for kind, out, idx in results
                if kind == overloadcheck.ACCEPTED]
    fresh = [_fresh(reqs, idx, "burst") for _out, idx in accepted]
    verdicts = _verdicts(oracle, fresh)
    # the other replica has seen none of the burst: its direct answers
    other = fleet["handles"][1]
    for (out, idx), req, want in zip(accepted, fresh, verdicts):
        assert overloadcheck.verdict_matches(out, want), idx
        st, _hd, data = _post(other.port,
                              json.dumps({"request": req}).encode())
        assert st == 200, idx
        assert out == json.loads(data)["response"], idx


def test_the_supervisor_respawns_a_killed_replica_warm(fleet):
    """SIGKILL one replica: it comes back restored and answers byte for
    byte as before; the other is never respawned; drain replies."""
    handles = fleet["handles"]
    sup = ReplicaSupervisor(snapshot_dir=fleet["snap"],
                            cache_dir=fleet["cache"], extra_flags=CPU,
                            env=ENV, spawn_timeout_s=SPAWN_S)
    for h in handles:
        sup.adopt(h)
    sup.start_monitor()
    try:
        victim = handles[1]
        old_pid = victim.proc.pid
        victim.kill()
        deadline = time.monotonic() + SPAWN_S + 10
        while time.monotonic() < deadline:
            st = sup.status()[victim.replica_id]
            if st["restarts"] == 1 and st["state"] == "running":
                break
            time.sleep(0.1)
        status = sup.status()
        assert status[victim.replica_id]["restarts"] == 1, status
        assert status[handles[0].replica_id]["restarts"] == 0, status
        fresh = next(h for h in sup.handles()
                     if h.replica_id == victim.replica_id)
        assert fresh.proc.pid != old_pid
        assert fresh.ready["restore_outcome"] == "restored"
        want = fleet["direct"][victim.replica_id]
        for i, body in enumerate(fleet["bodies"]):
            st, _hd, data = _post(fresh.port, body)
            assert st == 200 and data == want[i], i
        reply = sup.drain(victim.replica_id, deadline_ms=2000.0)
        assert reply["event"] == "drained" and reply["drained"], reply
        assert sup.status()[handles[0].replica_id]["restarts"] == 0
    finally:
        sup.stop()
