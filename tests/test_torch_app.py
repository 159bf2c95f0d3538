"""The port's process against the JAX package's, on the CPU.

Three Apps serve the same store, one after the other: the JAX package's
with ``--driver tpu`` (CPU JAX, ``DEVICE_MIN_CELLS = 0`` so its device path
serves), the JAX package's with ``--driver interp``, and the port's with
``--driver torch --torch-device cpu``.  Each gets a fresh InMemoryKube
holding five namespaces, a Config that syncs the corpora's kinds (Pods and
Namespaces among them) and exempts one namespace from the webhook, the
synthetic corpus at 12 templates x 300 pods (one constraint in dryrun) and
the referential corpus at 6 x 240.  Then, over HTTPS: the same 32
admission requests (byte-equal responses); one audit cycle from cache and
one by listing (equal constraint statuses); 16 pods added, updated and
deleted through the store and the next cycle (equal statuses, the port's
through its delta path); the /metrics family names.  The tolerance is
zero: every verdict and status is exact.

Also the entry's own contract: the port's App refuses to run on the CPU
unless asked, refuses each flag whose machinery it lacks, loads the
kernels when its driver is built on the card, and does not start when
they fail to load."""

import copy
import http.client
import json
import ssl
import time
import urllib.request

import numpy as np
import pytest
import torch

from gatekeeper_tpu.kube.inmem import InMemoryKube as JaxKube
from gatekeeper_tpu.main import App as JaxApp
from gatekeeper_tpu.main import build_parser as jax_parser
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube as TorchKube
from gatekeeper_tpu_torch.main import App as TorchApp
from gatekeeper_tpu_torch.main import UNPORTED_FLAGS
from gatekeeper_tpu_torch.main import build_parser as torch_parser
from gatekeeper_tpu_torch.util import synthetic as syn

N_TEMPLATES, N_PODS = 12, 300
N_REF_TEMPLATES, N_REF_OBJECTS = 6, 240
NAMESPACES = ("ns-0", "ns-1", "ns-2", "ns-3", "exempt-ns")
SERVED = NAMESPACES[:4]
EXEMPT = NAMESPACES[4]
# the corpora's seeds: templates, referential templates, stored pods,
# referential objects, admission pods, churned pods
SEEDS = [int(s) for s in np.random.default_rng(20261018).integers(
    0, 1 << 16, size=6)]
DRYRUN = 0  # the synthetic constraint put in dryrun (a labelreq clone)
CAP = 20  # --constraint-violations-limit's default
# stored pods that share one team (its readers are re-evaluated with any
# churn of the team, within the delta path's row limit)
CROWDED = 40
CGROUP = "constraints.gatekeeper.sh"
COMMON_FLAGS = [
    "--port", "0", "--prometheus-port", "0", "--health-addr", ":0",
    "--audit-from-cache", "--audit-interval", "3600",
    "--log-level", "WARNING",
]


def _api(obj):
    group, _, version = obj["apiVersion"].rpartition("/")
    return group, version


def corpus():
    """The store's objects, in the order a restart lists them."""
    templates, constraints = syn.make_templates(N_TEMPLATES, SEEDS[0])
    constraints[DRYRUN]["spec"]["enforcementAction"] = "dryrun"
    rtemplates, rconstraints = syn.make_referential_templates(
        N_REF_TEMPLATES, SEEDS[1])
    pods = syn.make_pods(N_PODS, SEEDS[2])
    for i, p in enumerate(pods):
        p["metadata"]["namespace"] = SERVED[i % len(SERVED)]
        if i >= CROWDED and "team" in p["metadata"]["labels"]:
            # a team of its own: the referential quota's key groups stay
            # small but for the first CROWDED pods' team, over its quota
            p["metadata"]["labels"]["team"] = f"team-{i}"
    refs = syn.make_referential_objects(N_REF_OBJECTS, SEEDS[3])
    for o in refs:
        md = o["metadata"]
        if "namespace" in md:
            md["namespace"] = SERVED[int(md["namespace"][3:]) % len(SERVED)]
            md["name"] = "ref-" + md["name"]
    namespaces = [{"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": ns}} for ns in NAMESPACES]
    config = {
        "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {
            "sync": {"syncOnly": [
                {"group": "", "version": "v1", "kind": "Pod"},
                {"group": "", "version": "v1", "kind": "Namespace"},
                {"group": "", "version": "v1",
                 "kind": "PersistentVolumeClaim"},
                {"group": "networking.k8s.io", "version": "v1",
                 "kind": "Ingress"},
                {"group": "storage.k8s.io", "version": "v1",
                 "kind": "StorageClass"},
            ]},
            "match": [{"excludedNamespaces": [EXEMPT],
                       "processes": ["webhook"]}],
        },
    }
    return (namespaces + [config] + templates + constraints + rtemplates
            + rconstraints + pods + refs)


def _request(uid, obj, operation="CREATE", old=None):
    src = obj if obj is not None else old
    group, version = _api(src)
    md = src["metadata"]
    return {
        "uid": uid,
        "kind": {"group": group, "version": version, "kind": src["kind"]},
        "name": md["name"], "namespace": md.get("namespace", ""),
        "operation": operation, "userInfo": {"username": "alice"},
        "object": obj, "oldObject": old,
    }


def admission_requests():
    """32 (path, request): unique pods, about half violating; one in the
    exempt namespace; a DELETE and an UPDATE with oldObject; a referential
    Ingress on a taken host and a PVC of a missing class; one
    /v1/admitlabel request.  Some pods violate the dryrun constraint."""
    pods = syn.make_pods(29, SEEDS[4], violation_rate=0.5)
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"adm-{i}"
        p["metadata"]["namespace"] = SERVED[i % len(SERVED)]
        if "team" in p["metadata"]["labels"]:
            # a team of its own: under the referential quota, which every
            # stored pod's team exceeds
            p["metadata"]["labels"]["team"] = f"team-adm-{i}"
    reqs = [("/v1/admit", _request(f"u{i}", p)) for i, p in
            enumerate(pods[:26])]
    exempt = copy.deepcopy(pods[26])
    exempt["metadata"]["namespace"] = EXEMPT
    reqs.append(("/v1/admit", _request("u-exempt", exempt)))
    reqs.append(("/v1/admit", _request("u-delete", None, "DELETE",
                                       old=pods[27])))
    newer = copy.deepcopy(pods[28])
    newer["metadata"]["labels"] = {}
    reqs.append(("/v1/admit", _request("u-update", newer, "UPDATE",
                                       old=pods[28])))
    ing = next(o for o in syn.make_referential_objects(N_REF_OBJECTS,
                                                       SEEDS[3])
               if o["kind"] == "Ingress")
    ing = copy.deepcopy(ing)
    ing["metadata"] = {"name": "adm-ing", "namespace": SERVED[0]}
    reqs.append(("/v1/admit", _request("u-ing", ing)))
    pvc = {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
           "metadata": {"name": "adm-pvc", "namespace": SERVED[1]},
           "spec": {"storageClassName": "missing-9"}}
    reqs.append(("/v1/admit", _request("u-pvc", pvc)))
    label_ns = {"apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": "labelled", "labels": {
                    "admission.gatekeeper.sh/ignore": "yes"}}}
    reqs.append(("/v1/admitlabel", _request("u-label", label_ns)))
    assert len(reqs) == 32
    return reqs


def churn(kube):
    """16 pods changed through the store: 6 added, 5 updated (labels
    dropped), 5 deleted."""
    stored = sorted((p for p in kube.list(("", "v1", "Pod"))
                     if not p["metadata"]["name"].startswith("ref-")),
                    key=lambda p: p["metadata"]["name"])
    rng = np.random.default_rng(SEEDS[5])
    picks = rng.choice(len(stored), size=10, replace=False)
    for j, p in enumerate(syn.make_pods(6, SEEDS[5], violation_rate=0.5)):
        p["metadata"]["name"] = f"churn-{j}"
        p["metadata"]["namespace"] = SERVED[j % len(SERVED)]
        kube.create(p)
    for i in picks[:5]:
        p = copy.deepcopy(stored[int(i)])
        p["metadata"]["labels"] = {"owner": "core"}
        kube.update(p)
    for i in picks[5:]:
        md = stored[int(i)]["metadata"]
        kube.delete(("", "v1", "Pod"), md["name"], md["namespace"])


def statuses(kube, kinds):
    out = {}
    for kind in kinds:
        for c in kube.list((CGROUP, "v1beta1", kind)):
            st = c.get("status") or {}
            out[(kind, c["metadata"]["name"])] = (
                st.get("totalViolations"), st.get("violations"))
    return out


def _synced(app, kube, timeout=120.0):
    """Wait until the controllers' queues are empty and the App's client
    holds every pod of its store at the store's resourceVersion."""
    pods = ("", "v1", "Pod")
    store = app.client.driver.store
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if app.manager.drain(timeout=60):
            with store._lock:
                spaces = store.tree.get("namespace") or {}
                held = {(ns, name): str(o["metadata"]["resourceVersion"])
                        for ns, gv in spaces.items()
                        for name, o in ((gv.get("v1") or {}).get("Pod")
                                        or {}).items()}
            if held == kube.list_rvs(pods):
                return
        time.sleep(0.01)
    raise AssertionError("the App's client does not hold its store's pods")


def _ctx():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def _ready(app, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(
                f"https://127.0.0.1:{app.webhook_server.port}/readyz",
                context=_ctx(), timeout=5,
            ) as r:
                if r.status == 200:
                    return True
        except Exception:
            pass
        time.sleep(0.05)
    return False


def drive(mode, tmp_path):
    """Start one App on a fresh store, drive it, stop it -> its record."""
    if mode == "torch":
        kube = TorchKube()
        args = torch_parser().parse_args(
            ["--driver", "torch", "--torch-device", "cpu",
             "--cert-dir", str(tmp_path / mode)] + COMMON_FLAGS)
        app = TorchApp(args, kube=kube)
    else:
        kube = JaxKube()
        args = jax_parser().parse_args(
            ["--driver", mode, "--sync-compile",
             "--cert-dir", str(tmp_path / mode)] + COMMON_FLAGS)
        app = JaxApp(args, kube=kube)
        if mode == "tpu":
            app.client.driver.DEVICE_MIN_CELLS = 0
    objs = corpus()
    for o in objs:
        kube.create(copy.deepcopy(o))
    kinds = sorted(o["kind"] for o in objs
                   if o["apiVersion"].startswith(CGROUP))
    rec = {}
    app.start()
    try:
        assert app.rotator is not None  # the webhook speaks TLS
        assert _ready(app), f"{mode}: /readyz never answered 200"
        _synced(app, kube)
        assert len(app.client.templates()) == N_TEMPLATES + N_REF_TEMPLATES
        conn = http.client.HTTPSConnection(
            "127.0.0.1", app.webhook_server.port, context=_ctx(),
            timeout=60)
        bodies = []
        for path, req in admission_requests():
            conn.request("POST", path, json.dumps({"request": req}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            bodies.append(resp.read())
        conn.close()
        rec["admission"] = bodies
        am = app.audit_manager
        assert am.run_once_guarded()
        rec["cache"] = statuses(kube, kinds)
        am.from_cache = False
        assert am.run_once_guarded()
        rec["listing"] = statuses(kube, kinds)
        am.from_cache = True
        churn(kube)
        _synced(app, kube)
        assert am.run_once_guarded()
        rec["churn"] = statuses(kube, kinds)
        rec["stats"] = dict(getattr(app.client.driver, "last_sweep_stats",
                                    {}) or {})
        with urllib.request.urlopen(
            f"http://127.0.0.1:{app.metrics_exporter.port}/metrics",
            timeout=10,
        ) as r:
            text = r.read().decode()
        rec["families"] = {ln.split()[2] for ln in text.splitlines()
                           if ln.startswith("# TYPE ")}
    finally:
        app.stop()
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("apps")
    return {mode: drive(mode, tmp) for mode in ("tpu", "interp", "torch")}


def test_admission_responses_are_byte_equal(runs):
    torch_bodies = runs["torch"]["admission"]
    assert torch_bodies == runs["tpu"]["admission"]
    assert torch_bodies == runs["interp"]["admission"]
    out = [json.loads(b)["response"] for b in torch_bodies]
    # the corpus reaches every kind of answer
    denied = [r for r in out if not r["allowed"]]
    assert len(denied) >= 5 and len(out) - len(denied) >= 5
    assert all(r["status"]["code"] == 403 for r in denied), denied
    by_uid = {r["uid"]: r for r in out}
    assert by_uid["u-exempt"]["allowed"]
    assert not by_uid["u-label"]["allowed"]
    assert not by_uid["u-ing"]["allowed"]
    assert not by_uid["u-pvc"]["allowed"]
    assert "denied by c-benchlabelreq0" not in "".join(
        r.get("status", {}).get("message", "") for r in out)


@pytest.mark.parametrize("cycle", ["cache", "listing", "churn"])
def test_constraint_statuses_are_equal(runs, cycle):
    """Byte-equal to the JAX device App's statuses after every cycle, and
    to the interpreter App's.  After churn a status list follows each
    driver's row order: both device drivers put an added pod in a freed
    row of their pack, the interpreter lists the store by key.  There the
    interpreter App's totals are equal, and so is each list below the cap
    as a set; a capped list (20 of more) may hold other rows."""
    got = runs["torch"][cycle]
    assert len(got) == N_TEMPLATES + N_REF_TEMPLATES
    assert got == runs["tpu"][cycle]
    interp = runs["interp"][cycle]
    if cycle != "churn":
        assert got == interp
    else:
        assert got.keys() == interp.keys()
        for key, (total, viols) in got.items():
            assert total == interp[key][0], key
            assert len(viols) == len(interp[key][1]), key
            if len(viols) < CAP:
                assert sorted(map(json.dumps, viols)) == sorted(
                    map(json.dumps, interp[key][1])), key
    assert sum(n for n, _v in got.values()) > 0
    assert any(len(v) == CAP for _n, v in got.values())
    # the dryrun constraint audits as usual
    dry = next(v for (k, _n), v in got.items()
               if k.endswith(f"Labelreq{DRYRUN}"))
    assert dry[0] > 0 and all(
        v["enforcementAction"] == "dryrun" for v in dry[1])


def test_the_churn_cycle_took_the_delta_path(runs):
    stats = runs["torch"]["stats"]
    assert "delta_rows" in stats, stats
    assert stats["delta_rows"] - stats.get("join_affected_rows", 0) == 16
    assert runs["torch"]["churn"] != runs["torch"]["cache"]


def test_metrics_expose_the_same_families(runs):
    fams = runs["torch"]["families"]
    assert "gatekeeper_request_count" in fams
    assert "gatekeeper_audit_duration_seconds" in fams
    assert fams == runs["interp"]["families"]
    assert fams == runs["tpu"]["families"]


# ---- the entry's own contract ----------------------------------------------


def _args(*flags):
    return torch_parser().parse_args(list(flags) + COMMON_FLAGS)


def test_the_driver_is_torch_on_the_card_by_default():
    args = _args()
    assert args.driver == "torch" and args.torch_device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TorchApp(args, kube=TorchKube())
    with pytest.raises(SystemExit):
        torch_parser().parse_args(["--driver", "tpu"])


@pytest.mark.parametrize("flags,item", [
    (["--jax-profile-port", "9999"], "A8"),
    (["--breaker-failure-threshold", "3"], "A6"),
    (["--breaker-cooldown-s", "5"], "A6"),
    (["--slo-trip-breaker"], "A6"),
])
def test_flags_the_port_lacks_are_refused(flags, item):
    with pytest.raises(ValueError, match=f"{flags[0]} .*ROADMAP {item}"):
        TorchApp(_args("--torch-device", "cpu", *flags), kube=TorchKube())
    assert flags[0] in {f for f, _g, _i in UNPORTED_FLAGS}


@pytest.mark.parametrize("flag", ["--xla-cache-dir", "--snapshot-dir"])
def test_the_cache_and_snapshot_flags_are_accepted(tmp_path, monkeypatch,
                                                   flag):
    """Both A8 flags construct an App: --xla-cache-dir points the kernels'
    build cache at DIR/torch_kernels (the CPU driver loads no kernel),
    --snapshot-dir is kept for start's restore."""
    from gatekeeper_tpu_torch import device

    monkeypatch.setattr(device, "BUILD_DIR", device.BUILD_DIR)
    app = TorchApp(_args("--torch-device", "cpu", flag, str(tmp_path)),
                   kube=TorchKube())
    if flag == "--xla-cache-dir":
        assert device.BUILD_DIR == str(tmp_path / "torch_kernels")
    else:
        assert app.args.snapshot_dir == str(tmp_path)
    assert flag not in {f for f, _g, _i in UNPORTED_FLAGS}


@pytest.mark.parametrize("env", ["GK_XLA_CACHE", "GK_SNAPSHOT_DIR"])
def test_the_jax_packages_variables_refuse_nothing(monkeypatch, env):
    """A deployment environment set for the JAX process (its compile
    cache, its snapshots) does not make the port refuse a flag that was
    never given: the port's parser does not read those variables."""
    monkeypatch.setenv(env, "/nonexistent")
    args = _args("--torch-device", "cpu")
    assert args.xla_cache_dir == "" and args.snapshot_dir == ""
    TorchApp(args, kube=TorchKube())


def test_sync_compile_is_accepted():
    app = TorchApp(_args("--torch-device", "cpu", "--sync-compile"),
                   kube=TorchKube())
    assert app.client.driver.wait_ready(timeout=0.0) is True


def test_wait_ready_on_the_cpu():
    from gatekeeper_tpu_torch.ops.driver import TorchDriver

    driver = TorchDriver(device="cpu")
    assert driver.wait_ready() is True
    assert driver.wait_ready(timeout=None) is True
    assert driver.kernels_load_s == 0.0


def test_the_kernels_load_when_the_driver_is_built_on_the_card(monkeypatch):
    """On a CUDA device the constructor loads the kernels (nvcc runs
    there, not in a review), wait_ready asks again, and a failed build
    raises from both."""
    from gatekeeper_tpu_torch.ops import driver as driver_mod

    calls = []
    monkeypatch.setattr(driver_mod, "select_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(driver_mod, "kernels", lambda: calls.append(1))
    driver = driver_mod.TorchDriver()
    assert calls == [1]
    assert driver.wait_ready(timeout=1.0) is True and calls == [1, 1]

    def broken():
        raise RuntimeError("kernel build failed: program.cu")

    monkeypatch.setattr(driver_mod, "kernels", broken)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        driver_mod.TorchDriver()
    with pytest.raises(RuntimeError, match="kernel build failed"):
        driver.wait_ready()


@pytest.mark.parametrize("outcome", ["raises", "false"])
def test_start_fails_before_serving_when_the_kernels_are_not_ready(
        tmp_path, outcome):
    app = TorchApp(_args("--torch-device", "cpu", "--cert-dir",
                         str(tmp_path)), kube=TorchKube())

    def not_ready(timeout=None):
        if outcome == "raises":
            raise RuntimeError("kernel build failed: match.cu")
        return False

    app.client.driver.wait_ready = not_ready
    with pytest.raises(RuntimeError, match="kernel build failed|not ready"):
        app.start()
    assert app.webhook_server is None and app.audit_manager is None
    assert app.metrics_exporter is None


def test_a_status_write_keeps_the_delta_basis():
    """The audit writes each constraint's status and the constraint
    controller re-puts it: a re-put that changes only the status and the
    resourceVersion keeps the constraint side's epoch (so the next cycle
    can take the delta path), any other change bumps it, and so does the
    stored dict mutated in place."""
    client = syn.build_driver(3, 40, SEEDS[0], device="cpu")
    driver = client.driver
    kind, name = next((k, n) for k in driver.constraints
                      for n in driver.constraints[k])
    stored = driver.constraints[kind][name]
    epoch = driver._cs_epoch
    written = copy.deepcopy(stored)
    written["status"] = {"totalViolations": 3, "violations": []}
    written["metadata"]["resourceVersion"] = "42"
    client.add_constraint(written)
    assert driver._cs_epoch == epoch
    assert driver.constraints[kind][name] is stored
    changed = copy.deepcopy(written)
    changed["spec"]["enforcementAction"] = "dryrun"
    client.add_constraint(changed)
    assert driver._cs_epoch == epoch + 1
    changed["metadata"]["labels"] = {"a": "b"}
    client.add_constraint(changed)
    assert driver._cs_epoch == epoch + 2


# ---- warm resume through the process ----------------------------------------


def _small_store():
    """Five namespaces, a Config syncing Pods, 4 synthetic templates and
    their constraints, 60 pods."""
    kube = TorchKube()
    for ns in NAMESPACES:
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": ns}})
    kube.create({
        "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {"sync": {"syncOnly": [
            {"group": "", "version": "v1", "kind": "Pod"}]}},
    })
    templates, constraints = syn.make_templates(4, SEEDS[0])
    pods = syn.make_pods(60, SEEDS[2])
    for i, p in enumerate(pods):
        p["metadata"]["namespace"] = SERVED[i % len(SERVED)]
    for o in templates + constraints + pods:
        kube.create(o)
    return kube, sorted(c["kind"] for c in constraints)


def test_a_restarted_app_restores_its_snapshot(tmp_path):
    """App 1 (--snapshot-dir, every role) cycles, writes a snapshot and
    stops; App 2 over the same store and directory restores it before
    its controllers start, and its first cycle's statuses equal App 1's,
    served from the restored delta basis (no full sweep)."""
    kube, kinds = _small_store()
    snap = str(tmp_path / "snapshots")

    def app_for(name):
        return TorchApp(_args("--torch-device", "cpu", "--cert-dir",
                              str(tmp_path / name), "--snapshot-dir", snap,
                              "--snapshot-interval", "86400"), kube=kube)

    first = app_for("first")
    first.start()
    try:
        assert first.snapshot_restore_outcome == "none"
        assert first.snapshotter is not None
        # the background writer stops before the cycle wakes it, so the
        # direct write below is the only one
        first.snapshotter.stop()
        assert _ready(first)
        _synced(first, kube)
        assert first.audit_manager.run_once_guarded()
        want = statuses(kube, kinds)
        assert sum(n for n, _v in want.values()) > 0
        assert first.snapshotter.write_once() is not None
    finally:
        first.stop()

    second = app_for("second")
    second.start()
    try:
        assert second.snapshot_restore_outcome == "restored"
        assert second.client.driver._delta_state is not None
        second.snapshotter.stop()
        assert _ready(second)
        _synced(second, kube)
        assert second.audit_manager.run_once_guarded()
        stats = second.client.driver.last_sweep_stats
        assert stats.get("cached") == 1.0, stats
        assert statuses(kube, kinds) == want
    finally:
        second.stop()
