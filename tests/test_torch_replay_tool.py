"""tools/replay_decisions_torch.py, the decision log's differential
replay on the port, on the CPU (``--torch-device cpu``).

The five tests of tests/test_replay_tool.py on the port's tool and
TorchDriver: the selftest in a subprocess (record a synthetic corpus,
replay it at zero drift, then under GK_BUG_COMPAT=1 require the seeded
divergence to be flagged), zero drift on the same engine, the seeded
drift flagged with route attribution, skipped records, and no replay
archived into its own corpus.  Then the two engines against each other
on recorded traffic, the tolerance zero (verdict, code and message
digest of every decision): a sealed log recorded through the JAX
handler (TpuDriver on CPU JAX) replays at zero drift through the port's
tool, and a log recorded through the port's handler replays at zero
drift through the JAX tool's ``replay_records``."""

import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import replay_decisions as rp  # noqa: E402
import replay_decisions_torch as rpt  # noqa: E402

from .test_snapshot_concurrent import spawn_available

TOOL = os.path.join(os.path.dirname(__file__), "..", "tools",
                    "replay_decisions_torch.py")
DEVICE = "cpu"


def _port_log():
    from gatekeeper_tpu_torch.obs import decisionlog as dlog

    return dlog.get_log()


def _jax_log():
    from gatekeeper_tpu.obs import decisionlog as dlog

    return dlog.get_log()


class _Recording:
    """One package's process-global decision log archiving into a
    directory for the ``with``, detached and emptied after."""

    def __init__(self, log, path, seal):
        self.log, self.path, self.seal = log, str(path), seal

    def __enter__(self):
        self.log.clear()
        self.log.configure(dir=self.path, seal=self.seal, sample_rate=1.0)
        self.log.record_enabled = True
        self.log.start()
        return self.log

    def __exit__(self, *exc):
        self.log.stop()
        self.log.record_enabled = False
        self.log.clear()
        self.log.configure(dir="", sample_rate=1.0, seal=False)
        self.log.record_enabled = True


@spawn_available
def test_selftest_passes_in_a_subprocess():
    env = dict(os.environ)
    env.pop("GK_BUG_COMPAT", None)
    proc = subprocess.run(
        [sys.executable, TOOL, "--selftest", "--torch-device", DEVICE],
        capture_output=True, text=True, timeout=420, env=env,
    )
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "seeded drift flagged" in proc.stdout


@spawn_available
def test_without_a_card_the_default_engine_fails_with_rc_2(tmp_path):
    """--torch-device defaults to the card, as the App's flag does: on a
    machine without one the engine does not build and the tool exits 2
    (never a quiet CPU replay)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    proc = subprocess.run(
        [sys.executable, TOOL, "--log-dir", str(tmp_path),
         "--snapshot-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2, (proc.stdout, proc.stderr)
    assert "engine restore failed" in proc.stderr


class TestReplayMechanics:
    def test_zero_drift_on_identical_engine(self, tmp_path, monkeypatch):
        monkeypatch.delenv("GK_BUG_COMPAT", raising=False)
        with _Recording(_port_log(), tmp_path, seal=True) as log:
            handler = rpt._selftest_handler(device=DEVICE)
            for req in rpt.selftest_requests(n=12, divergent=2):
                handler.handle(req)
            log.flush()
            records, problems = rpt.load_records(str(tmp_path),
                                                 require_seal=True)
            assert problems == []
            report = rpt.replay_records(handler, records)
            assert report["replayed"] == 12
            assert report["drift_count"] == 0

    def test_bug_compat_divergence_is_flagged_with_route_attribution(
        self, tmp_path, monkeypatch,
    ):
        monkeypatch.delenv("GK_BUG_COMPAT", raising=False)
        with _Recording(_port_log(), tmp_path, seal=False) as log:
            handler = rpt._selftest_handler(device=DEVICE)
            for req in rpt.selftest_requests(n=10, divergent=3):
                handler.handle(req)
            log.flush()
            records, _problems = rpt.load_records(str(tmp_path))
            monkeypatch.setenv("GK_BUG_COMPAT", "1")
            report = rpt.replay_records(
                rpt._selftest_handler(device=DEVICE), records)
            assert report["drift_count"] >= 3
            d = report["drift"][0]
            # drift entries carry BOTH sides' verdicts + route attribution
            assert d["recorded"]["verdict"]["allowed"] is False
            assert d["replayed"]["allowed"] is True
            assert "route" in d["recorded"] and "route" in d["replayed"]
            # the port records a route (TorchDriver's ledger), and the
            # report counts the live router's choices
            assert d["recorded"]["route"] is not None
            assert d["replayed"]["route"] is not None
            assert sum(report["routes"].values()) >= 1

    def test_masked_and_transient_records_are_skipped(self):
        from gatekeeper_tpu_torch.obs import decisionlog as dlog

        records = [
            {"kind": "admission", "class": "allow", "masked": ["x"],
             "request": {"uid": "m"}},
            {"kind": "admission", "class": "shed",
             "request": {"uid": "s"},
             "verdict": {"allowed": False, "code": 429}},
            {"kind": dlog.KIND_AUDIT_TRANSITION, "transition": "new"},
        ]

        class NeverCalled:
            def handle(self, req):  # pragma: no cover - must not run
                raise AssertionError("skipped records must not replay")

        report = rpt.replay_records(NeverCalled(), records)
        assert report["replayed"] == 0
        assert report["skipped_masked"] == 1
        assert report["skipped_transient"] == 1
        assert report["skipped_other"] == 1

    def test_replay_never_rearchives_into_the_corpus(self, tmp_path,
                                                     monkeypatch):
        """Recording pauses during replay: the archive must not grow
        with its own replays."""
        monkeypatch.delenv("GK_BUG_COMPAT", raising=False)
        with _Recording(_port_log(), tmp_path, seal=False) as log:
            handler = rpt._selftest_handler(device=DEVICE)
            for req in rpt.selftest_requests(n=6, divergent=0):
                handler.handle(req)
            log.flush()
            records, _ = rpt.load_records(str(tmp_path))
            recorded_before = log.recorded
            rpt.replay_records(handler, records)
            assert log.recorded == recorded_before
            assert log.record_enabled is True  # restored afterwards


def _handler(tool, forced, **kw):
    """The tool's selftest engine; ``forced`` pins its driver's device
    path (DEVICE_MIN_CELLS = 0), else it routes by its price."""
    handler = tool._selftest_handler(**kw)
    if forced:
        handler.client.driver.DEVICE_MIN_CELLS = 0
    return handler


@pytest.mark.parametrize("forced", [False, True], ids=["priced", "device"])
def test_a_log_the_jax_handler_recorded_replays_on_the_port(
        tmp_path, monkeypatch, forced):
    """TpuDriver (CPU JAX) decides and the JAX decision log seals; the
    port's tool verifies the seal chain and replays every decision
    through TorchDriver at zero drift."""
    monkeypatch.delenv("GK_BUG_COMPAT", raising=False)
    reqs = rp.selftest_requests(n=24, divergent=4)
    with _Recording(_jax_log(), tmp_path, seal=True) as log:
        handler = _handler(rp, forced)
        denied = sum(not handler.handle(r).allowed for r in reqs)
        log.flush()
    records, problems = rpt.load_records(str(tmp_path), require_seal=True)
    assert problems == []
    assert sum(1 for r in records if r.get("kind") == "admission") == 24
    report = rpt.replay_records(_handler(rpt, forced, device=DEVICE),
                                records)
    assert report["replayed"] == 24 and denied >= 4
    assert report["drift_count"] == 0, report["drift"][:2]
    if forced:
        assert set(report["routes"]) == {"device|forced_device"}


@pytest.mark.parametrize("forced", [False, True], ids=["priced", "device"])
def test_a_log_the_port_recorded_replays_on_the_jax_tool(
        tmp_path, monkeypatch, forced):
    """The reverse: TorchDriver decides, the port's decision log seals,
    and the JAX tool's replay_records replays every decision through
    TpuDriver at zero drift."""
    monkeypatch.delenv("GK_BUG_COMPAT", raising=False)
    reqs = rpt.selftest_requests(n=24, divergent=4)
    with _Recording(_port_log(), tmp_path, seal=True) as log:
        handler = _handler(rpt, forced, device=DEVICE)
        denied = sum(not handler.handle(r).allowed for r in reqs)
        log.flush()
    records, problems = rp.load_records(str(tmp_path), require_seal=True)
    assert problems == []
    if forced:
        assert {r["route"]["tier"] for r in records} == {"device"}
    report = rp.replay_records(_handler(rp, forced), records)
    assert report["replayed"] == 24 and denied >= 4
    assert report["drift_count"] == 0, report["drift"][:2]


def _app_store(n_templates: int, n_pods: int, sync_namespaces: bool):
    """An API store as phase 14 of chip_smoke seeds it: templates,
    constraints, namespaces, pods and a Config syncing Pods (and
    Namespaces where asked)."""
    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
    from gatekeeper_tpu_torch.util import synthetic as syn

    kube = InMemoryKube()
    templates, constraints = syn.make_templates(n_templates, 0)
    pods = syn.make_pods(n_pods, 1)
    for ns in sorted({p["metadata"]["namespace"] for p in pods}):
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": ns, "labels": {"team": ns}}})
    kinds = [{"group": "", "version": "v1", "kind": "Pod"}]
    if sync_namespaces:
        kinds.append({"group": "", "version": "v1", "kind": "Namespace"})
    kube.create({"apiVersion": "config.gatekeeper.sh/v1alpha1",
                 "kind": "Config",
                 "metadata": {"name": "config",
                              "namespace": "gatekeeper-system"},
                 "spec": {"sync": {"syncOnly": kinds}}})
    for obj in templates + constraints + pods:
        kube.create(obj)
    return kube, len(constraints)


@pytest.mark.parametrize("sync_namespaces", [True, False],
                         ids=["namespaces_synced", "pods_only"])
def test_an_apps_log_replays_against_its_snapshot(tmp_path, capsys,
                                                  sync_namespaces):
    """The operator's path: a port App (--driver torch on the CPU)
    records sealed decisions and writes a snapshot after its cycle; the
    tool restores that snapshot and replays the log.  With Namespaces
    synced the snapshot holds the namespace cache the decisions read and
    every one replays at zero drift; with Pods alone it holds none, the
    tool says so, and the namespaced requests drift (rc 1): a replay
    needs the state that decided."""
    import json as _json

    from gatekeeper_tpu_torch.main import App, build_parser
    from gatekeeper_tpu_torch.util import synthetic as syn

    kube, n_constraints = _app_store(6, 120, sync_namespaces)
    decisions, snaps = tmp_path / "d", tmp_path / "s"
    flags = ["--driver", "torch", "--torch-device", DEVICE, "--port", "0",
             "--prometheus-port", "0", "--health-addr", ":0",
             "--audit-from-cache", "--audit-interval", "86400",
             "--log-level", "WARNING", "--cert-dir", str(tmp_path / "c"),
             "--decision-log-dir", str(decisions), "--decision-log-seal",
             "--snapshot-dir", str(snaps), "--snapshot-interval", "86400"]
    app = App(build_parser().parse_args(flags), kube=kube)
    app.client.driver.DEVICE_MIN_CELLS = 0
    app.start()
    try:
        app.snapshotter.stop()
        assert app.manager.drain(timeout=60)
        handler = app.webhook_server.validation_handler
        for i, pod in enumerate(syn.make_pods(12, seed=7,
                                              violation_rate=0.5)):
            pod["metadata"]["name"] = f"replayed-{i}"
            md = pod["metadata"]
            handler.handle({
                "uid": f"r{i}", "operation": "CREATE",
                "kind": {"group": "", "version": "v1", "kind": "Pod"},
                "name": md["name"], "namespace": md["namespace"],
                "userInfo": {"username": "replay"}, "object": pod})
        assert app.audit_manager.run_once_guarded()
        assert app.snapshotter.write_once() is not None
    finally:
        app.stop()
    capsys.readouterr()
    rc = rpt.main(["--log-dir", str(decisions), "--snapshot-dir",
                   str(snaps), "--torch-device", DEVICE, "--require-seal",
                   "--json"])
    out = capsys.readouterr()
    report = _json.loads(out.out)
    assert report["replayed"] == 12
    if sync_namespaces:
        assert rc == 0 and report["drift_count"] == 0, report["drift"][:2]
        assert sum(report["routes"].values()) >= 1
    else:
        assert rc == 1 and report["drift_count"] == 12
        assert "holds no Namespace" in out.err
        assert "not found" in report["drift"][0]["replayed"]["message"]


def test_a_restored_namespace_leaf_is_read_as_json():
    """A snapshot restore adopts the inventory's leaves unfrozen where no
    template reads the inventory; the namespace cache must read such a
    leaf (the JAX package's store raises TypeError there: thaw refuses a
    plain dict)."""
    from gatekeeper_tpu.client.drivers import InventoryStore as JaxStore
    from gatekeeper_tpu_torch.client.drivers import InventoryStore

    ns = {"apiVersion": "v1", "kind": "Namespace",
          "metadata": {"name": "ns-0", "labels": {"team": "a"}}}
    store = InventoryStore()
    store.adopt_tree({"cluster": {"v1": {"Namespace": {"ns-0": ns}}}},
                     leaves_frozen=False)
    got = store.cached_namespace("ns-0")
    assert got == ns and got is not ns
    jax_store = JaxStore()
    jax_store.adopt_tree({"cluster": {"v1": {"Namespace": {"ns-0": ns}}}},
                         leaves_frozen=False)
    with pytest.raises(TypeError, match="cannot thaw"):
        jax_store.cached_namespace("ns-0")
