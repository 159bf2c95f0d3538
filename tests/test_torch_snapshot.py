"""The port's snapshots and warm resume (gatekeeper_tpu_torch/snapshot/)
on the CPU.

First the deterministic cases of tests/test_snapshot.py on
``Client(driver=TorchDriver(device="cpu"))``: the round trip (write,
restart, restore, a first sweep equal to the cold one with no rebuild and
no re-pack), the delta basis kept at the same mesh width and dropped when
the width drifts (``GK_VIRTUAL_DEVICES`` slots), the delta resync packing
only the churn, the writer's skip while the store is ahead of the pack,
retention, and each validation failure falling back with its outcome
counted.  No case depends on thread timing.

Then the port against the JAX package: the same seeded corpus
(util/synthetic.py, its referential corpus for joins) written, churned
and restored by TpuDriver on the CPU JAX backend and by TorchDriver on
the CPU gives byte-equal capped and uncapped results, equal totals, equal
``loader.stats``, bit-equal restored masks (equal to the writer's) and
[C, 1+K] reductions, and the InterpDriver oracle's results; at mesh
widths 1 and 2.  Last, the code fingerprint: a kernel source edited
after a snapshot was written makes that snapshot fall back.  Tolerance 0
throughout: every compared value is a bool, an int or a string.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from gatekeeper_tpu.client.client import Client as JaxClient
from gatekeeper_tpu.client.drivers import InterpDriver
from gatekeeper_tpu.kube.inmem import InMemoryKube as JaxKube
from gatekeeper_tpu.ops.driver import TpuDriver, _packed_reduction
from gatekeeper_tpu.snapshot import SnapshotLoader as JaxLoader
from gatekeeper_tpu.snapshot import Snapshotter as JaxSnapshotter
from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.metrics.views import global_registry
from gatekeeper_tpu_torch.ops.auditpack import AuditPackCache
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.ops.reduction import packed_reduction_plain
from gatekeeper_tpu_torch.parallel.mesh import ShardedMask
from gatekeeper_tpu_torch.snapshot import SnapshotLoader, Snapshotter
from gatekeeper_tpu_torch.snapshot import format as snapfmt
from gatekeeper_tpu_torch.util import seal as sealmod
from gatekeeper_tpu_torch.util import synthetic as syn

from .test_torch_controllers import CONSTRAINT, TEMPLATE

NS_GVK = ("", "v1", "Namespace")
CAP = 20


def ns_obj(name, labeled):
    labels = {"team": name}
    if labeled:
        labels["gatekeeper"] = "yes"
    return {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {"name": name, "labels": labels},
    }


def build_cluster(n=12, labeled_every=2):
    """An API store with n Namespaces (RV-stamped), every
    `labeled_every`-th compliant."""
    kube = InMemoryKube()
    for i in range(n):
        kube.create(ns_obj(f"ns-{i:03d}", labeled=i % labeled_every == 0))
    return kube


@pytest.fixture()
def mesh_slots(monkeypatch):
    """GK_VIRTUAL_DEVICES slots of the CPU: a mesh of any width up to 4."""
    monkeypatch.setenv("GK_VIRTUAL_DEVICES", "4")


def fresh_client(mesh_width=None):
    """A port client pinned to a known sweep sharding: one device by
    default; mesh_width asks for that many GK_VIRTUAL_DEVICES slots."""
    client = Client(driver=TorchDriver(device="cpu"))
    client.driver.set_mesh(mesh_width is not None, width=mesh_width)
    return client


def make_client(kube, mesh_width=None):
    client = fresh_client(mesh_width)
    client.add_template(TEMPLATE)
    client.add_constraint(CONSTRAINT)
    for obj in kube.list(NS_GVK):
        client.add_data(obj)
    return client


def audit_sig(client):
    res, totals = client.audit_capped(CAP)
    sig = sorted(
        ((r.resource or {}).get("metadata", {}).get("name", ""), r.msg)
        for r in res.results()
    )
    return sig, totals


def outcome_counts():
    rows = global_registry().view_rows("snapshot_restore_outcome_total")
    return {k[0]: v for k, v in rows.items()}


@pytest.fixture()
def snap_dir(tmp_path):
    return str(tmp_path / "snapshots")


def host_mask(mask) -> np.ndarray:
    """A resident mask (tensor or ShardedMask) on the host."""
    if isinstance(mask, ShardedMask):
        return mask.host()
    return mask.cpu().numpy()


class _Counts:
    """Per-row re-packs and full rebuilds of one driver's audit pack."""

    def __init__(self, monkeypatch, driver):
        self.packs = self.rebuilds = 0
        pack_row, rebuild = AuditPackCache._pack_row, AuditPackCache._rebuild

        def counted_pack(ap, *a, **k):
            if ap is driver._audit_pack:
                self.packs += 1
            return pack_row(ap, *a, **k)

        def counted_rebuild(ap, *a, **k):
            if ap is driver._audit_pack:
                self.rebuilds += 1
            return rebuild(ap, *a, **k)

        monkeypatch.setattr(AuditPackCache, "_pack_row", counted_pack)
        monkeypatch.setattr(AuditPackCache, "_rebuild", counted_rebuild)


class TestRoundTrip:
    def test_warm_resume_equals_cold_and_skips_repack(self, snap_dir,
                                                      monkeypatch):
        kube = build_cluster(n=12)
        client1 = make_client(kube)
        cold_sig, cold_totals = audit_sig(client1)
        assert cold_sig  # the corpus violates
        written = host_mask(client1.driver._delta_state.mask_src.get())

        path = Snapshotter(client1, snap_dir, interval_s=0.0).write_once()
        assert path is not None and os.path.isdir(path)
        assert snapfmt.list_snapshots(snap_dir) == [os.path.basename(path)]
        assert os.stat(snap_dir).st_mode & 0o777 == 0o700

        client2 = fresh_client()
        counts = _Counts(monkeypatch, client2.driver)
        loader = SnapshotLoader(snap_dir)
        assert loader.restore(client2, kube) == "restored"
        assert loader.stats == {
            "matched": 12, "changed": 0, "added": 0, "deleted": 0,
        }
        assert loader.delta_restored is True
        warm_sig, warm_totals = audit_sig(client2)
        assert (warm_sig, warm_totals) == (cold_sig, cold_totals)
        # no rebuild, no per-row re-pack, and with zero churn the restored
        # basis serves the sweep: no evaluation, and the mask stays on
        # the host until a delta sweep needs it
        assert counts.rebuilds == 0 and counts.packs == 0
        assert client2.driver.last_sweep_stats.get("cached") == 1.0
        src = client2.driver._delta_state.mask_src
        assert src.peek() is None  # never resolved: not uploaded
        restored = src.get()
        assert isinstance(restored, torch.Tensor)
        assert restored.dtype == torch.bool
        assert restored.device == client2.driver.device
        np.testing.assert_array_equal(restored.numpy(), written)
        frozen = client2.driver.store.frozen()
        hash(frozen["cluster"]["v1"]["Namespace"]["ns-000"])

    @pytest.mark.parametrize("width", [2, 3])
    def test_delta_basis_roundtrips_under_same_mesh_width(
            self, snap_dir, mesh_slots, width):
        """A mesh process's basis restores into another process of the
        same width, its ShardedMask slabs back on their shards (width 3
        pads the slabs past the pack's capacity), and churn after the
        restore takes the delta path against the restored slabs."""
        kube = build_cluster(n=12)
        client1 = make_client(kube, mesh_width=width)
        cold_sig, _ = audit_sig(client1)
        written = client1.driver._delta_state.mask_src.get()
        assert isinstance(written, ShardedMask)
        assert Snapshotter(client1, snap_dir, interval_s=0.0).write_once()

        client2 = fresh_client(mesh_width=width)
        loader = SnapshotLoader(snap_dir)
        assert loader.restore(client2, kube) == "restored"
        assert loader.delta_restored is True
        warm_sig, _ = audit_sig(client2)
        assert warm_sig == cold_sig
        assert client2.driver.last_sweep_stats.get("cached") == 1.0
        restored = client2.driver._delta_state.mask_src.get()
        assert isinstance(restored, ShardedMask)
        assert len(restored.slabs) == width
        assert restored.rows == written.rows
        for got, want in zip(restored.slabs, written.slabs):
            assert got.shape == want.shape and got.is_contiguous()
            assert torch.equal(got, want)
        flipped = kube.get(NS_GVK, "ns-000")
        flipped["metadata"]["labels"].pop("gatekeeper", None)
        kube.update(flipped)
        client2.add_data(kube.get(NS_GVK, "ns-000"))
        churn_sig, _ = audit_sig(client2)
        assert client2.driver.last_sweep_stats.get("delta_rows") == 1.0
        ref_sig, _ = audit_sig(make_client(kube, mesh_width=width))
        assert churn_sig == ref_sig

    def test_delta_basis_dropped_on_mesh_width_drift(self, snap_dir,
                                                     mesh_slots):
        """A width-1 basis restores at width 1 and is dropped at width 4
        (the pack stays restored); and a width-2 basis is dropped at
        width 1, whose first sweep is a full one with the same verdicts."""
        kube = build_cluster(n=12)
        client1 = make_client(kube)
        cold_sig, _ = audit_sig(client1)
        assert Snapshotter(client1, snap_dir, interval_s=0.0).write_once()

        same = fresh_client()
        loader = SnapshotLoader(snap_dir)
        assert loader.restore(same, kube) == "restored"
        assert loader.delta_restored is True

        drifted = fresh_client(mesh_width=4)
        loader2 = SnapshotLoader(snap_dir)
        assert loader2.restore(drifted, kube) == "restored"
        assert loader2.delta_restored is False
        assert drifted.driver._delta_state is None
        warm_sig, _ = audit_sig(drifted)
        assert warm_sig == cold_sig
        assert drifted.driver.last_sweep_stats.get("cached") != 1.0

        wide_dir = snap_dir + "-w2"
        wide = make_client(kube, mesh_width=2)
        audit_sig(wide)
        assert Snapshotter(wide, wide_dir, interval_s=0.0).write_once()
        narrow = fresh_client()
        loader3 = SnapshotLoader(wide_dir)
        assert loader3.restore(narrow, kube) == "restored"
        assert loader3.delta_restored is False
        narrow_sig, _ = audit_sig(narrow)
        assert narrow_sig == cold_sig
        st = narrow.driver.last_sweep_stats
        assert "delta_rows" not in st and st.get("cached") != 1.0
        assert st["shards"] == 1.0

    def test_delta_resync_packs_only_churn(self, snap_dir, monkeypatch):
        kube = build_cluster(n=10)
        client1 = make_client(kube)
        audit_sig(client1)
        assert Snapshotter(client1, snap_dir).write_once() is not None

        # churn while "down": flip one compliant ns to violating, delete
        # one violating ns, add one new violating ns
        flipped = kube.get(NS_GVK, "ns-000")
        del flipped["metadata"]["labels"]["gatekeeper"]
        kube.update(flipped)
        kube.delete(NS_GVK, "ns-001")
        kube.create(ns_obj("ns-new", labeled=False))

        client2 = fresh_client()
        counts = _Counts(monkeypatch, client2.driver)
        loader = SnapshotLoader(snap_dir)
        assert loader.restore(client2, kube) == "restored"
        assert loader.stats == {
            "matched": 8, "changed": 1, "added": 1, "deleted": 1,
        }
        assert loader.delta_restored is True
        warm_sig, _ = audit_sig(client2)
        # changed + added + tombstoned = 3 dirty rows on the delta path
        assert client2.driver.last_sweep_stats.get("delta_rows") == 3.0
        cold_sig, _ = audit_sig(make_client(kube))
        assert warm_sig == cold_sig
        names = [n for n, _ in warm_sig]
        assert "ns-000" in names and "ns-new" in names
        assert "ns-001" not in names
        assert counts.rebuilds == 0
        assert counts.packs == 2  # the flipped and the added row only

    def test_writer_skips_when_store_ahead_of_pack(self, snap_dir):
        kube = build_cluster(n=4)
        client = make_client(kube)
        audit_sig(client)
        kube.create(ns_obj("ns-late", labeled=False))
        client.add_data(kube.get(NS_GVK, "ns-late"))
        snapper = Snapshotter(client, snap_dir, capture_delta=False)
        assert snapper.write_once() is None
        assert "ahead of pack" in (snapper.last_error or "")
        audit_sig(client)  # the sweep re-syncs the pack
        assert snapper.write_once() is not None

    def test_retention_prunes_old_snapshots(self, snap_dir):
        kube = build_cluster(n=3)
        client = make_client(kube)
        audit_sig(client)
        snapper = Snapshotter(client, snap_dir, retain=2,
                              capture_delta=False)
        paths = []
        for _ in range(4):
            snapper._last_write = 0.0  # defeat the cadence for the test
            p = snapper.write_once()
            assert p is not None
            paths.append(os.path.basename(p))
        names = snapfmt.list_snapshots(snap_dir)
        assert len(names) == 2
        assert names[0] == paths[-1]

    def test_no_snapshot_means_cold_outcome_none(self, snap_dir):
        kube = build_cluster(n=2)
        before = outcome_counts().get("none", 0)
        assert SnapshotLoader(snap_dir).restore(fresh_client(), kube) == \
            "none"
        assert outcome_counts().get("none", 0) == before + 1


class TestValidationFallback:
    def _snapshot(self, snap_dir, n=6):
        kube = build_cluster(n=n)
        client = make_client(kube)
        sig, _ = audit_sig(client)
        snapper = Snapshotter(client, snap_dir, capture_delta=False)
        assert snapper.write_once() is not None
        return kube, sig

    @staticmethod
    def _newest(snap_dir):
        return os.path.join(snap_dir, snapfmt.list_snapshots(snap_dir)[0])

    def _assert_fallback_then_cold_ok(self, snap_dir, kube, cold_sig):
        before = outcome_counts().get("fallback", 0)
        client = fresh_client()
        assert SnapshotLoader(snap_dir).restore(client, kube) == "fallback"
        assert outcome_counts().get("fallback", 0) == before + 1
        # the cold path still serves correct results
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
        for obj in kube.list(NS_GVK):
            client.add_data(obj)
        sig, _ = audit_sig(client)
        assert sig == cold_sig

    def _edit_manifest(self, snap_dir, edit):
        mpath = os.path.join(self._newest(snap_dir), snapfmt.MANIFEST)
        with open(mpath) as f:
            manifest = json.load(f)
        edit(manifest)
        with open(mpath, "w") as f:
            json.dump(manifest, f)

    def test_corrupt_manifest_falls_back(self, snap_dir):
        kube, sig = self._snapshot(snap_dir)
        # a content change breaks the hmac too
        self._edit_manifest(snap_dir,
                            lambda m: m.__setitem__("schema", 999))
        self._assert_fallback_then_cold_ok(snap_dir, kube, sig)

    def test_wrong_hmac_falls_back(self, snap_dir):
        kube, sig = self._snapshot(snap_dir)
        self._edit_manifest(snap_dir,
                            lambda m: m.__setitem__("hmac", "0" * 64))
        self._assert_fallback_then_cold_ok(snap_dir, kube, sig)

    def test_truncated_array_falls_back(self, snap_dir):
        kube, sig = self._snapshot(snap_dir)
        apath = os.path.join(self._newest(snap_dir), snapfmt.ARRAYS)
        with open(apath, "rb") as f:
            blob = f.read()
        with open(apath, "wb") as f:
            f.write(blob[: len(blob) // 2])
        self._assert_fallback_then_cold_ok(snap_dir, kube, sig)

    def test_tampered_payload_fails_checksum(self, snap_dir):
        kube, sig = self._snapshot(snap_dir)
        ipath = os.path.join(self._newest(snap_dir), snapfmt.INTERNER)
        with open(ipath) as f:
            strings = json.load(f)
        with open(ipath, "w") as f:
            json.dump(strings + ["evil"], f)
        self._assert_fallback_then_cold_ok(snap_dir, kube, sig)

    def test_fully_stale_resource_versions_fall_back(self, snap_dir):
        kube, _sig = self._snapshot(snap_dir)
        for obj in kube.list(NS_GVK):
            obj["metadata"]["labels"]["touched"] = "yes"
            kube.update(obj)
        before = outcome_counts().get("fallback", 0)
        client = fresh_client()
        loader = SnapshotLoader(snap_dir)
        assert loader.restore(client, kube) == "fallback"
        assert loader.stats["matched"] == 0
        assert outcome_counts().get("fallback", 0) == before + 1
        # safe degradation: every row re-packs and the sweep is correct
        warm_sig, _ = audit_sig(client)
        cold_sig, _ = audit_sig(make_client(kube))
        assert warm_sig == cold_sig

    def test_older_snapshot_used_when_newest_corrupt(self, snap_dir):
        kube, sig = self._snapshot(snap_dir)
        client1 = make_client(kube)
        audit_sig(client1)
        snapper = Snapshotter(client1, snap_dir, capture_delta=False)
        snapper._last_write = 0.0
        newest = snapper.write_once()
        assert newest is not None
        with open(os.path.join(newest, snapfmt.ARRAYS), "ab") as f:
            f.write(b"garbage")
        before = outcome_counts().get("quarantined", 0)
        client2 = fresh_client()
        assert SnapshotLoader(snap_dir).restore(client2, kube) == "restored"
        assert outcome_counts().get("quarantined", 0) == before + 1
        warm_sig, _ = audit_sig(client2)
        assert warm_sig == sig


# ---- the port against the JAX package --------------------------------------


def _jax_client(width):
    driver = TpuDriver()
    driver.set_mesh(width > 1, width=width if width > 1 else None)
    return JaxClient(driver=driver)


def _torch_client(width):
    client = Client(driver=TorchDriver(device="cpu"))
    client.driver.set_mesh(width > 1, width=width if width > 1 else None)
    return client


def _fill(client, objects):
    templates, constraints, data = objects
    for t in templates:
        client.add_template(copy.deepcopy(t))
    for c in constraints:
        client.add_constraint(copy.deepcopy(c))
    for o in data:
        client.add_data(o)
    return client


def stored(kube) -> list:
    """Every object of the store, resourceVersions stamped, in the
    store's order."""
    return [o for gvk in kube.list_gvks() for o in kube.list(gvk)]


def _rendered(results) -> str:
    """Results in the driver's own order, as bytes."""
    return json.dumps([
        [r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
         r.enforcement_action,
         ((r.review.get("object") or {}).get("metadata") or {}).get(
             "namespace"),
         ((r.review.get("object") or {}).get("metadata") or {}).get(
             "name")]
        for r in results
    ], sort_keys=True)


def synthetic_corpus():
    templates, constraints = syn.make_templates(8, 31)
    return templates, constraints, syn.make_pods(300, 32)


def referential_corpus():
    templates, constraints = syn.make_referential_templates(6, 33)
    return templates, constraints, syn.make_referential_objects(240, 34)


def churn_synthetic(kube):
    """12 pods changed in the store: 4 added, 4 relabelled, 4 deleted."""
    pods = sorted(kube.list(("", "v1", "Pod")),
                  key=lambda p: (p["metadata"]["namespace"],
                                 p["metadata"]["name"]))
    for j, p in enumerate(syn.make_pods(4, 35, violation_rate=0.5)):
        p["metadata"]["name"] = f"churn-{j}"
        kube.create(p)
    for p in pods[3:7]:
        p["metadata"]["labels"] = {"owner": "core"}
        kube.update(p)
    for p in pods[10:14]:
        kube.delete(("", "v1", "Pod"), p["metadata"]["name"],
                    p["metadata"]["namespace"])


def churn_referential(kube):
    """A team pod moved to another team, an Ingress host moved onto a
    taken one, a claim's class dropped, and one pod deleted."""
    pods = sorted(kube.list(("", "v1", "Pod")),
                  key=lambda p: p["metadata"]["name"])
    ings = sorted(kube.list(("networking.k8s.io", "v1", "Ingress")),
                  key=lambda p: p["metadata"]["name"])
    pvcs = sorted(kube.list(("", "v1", "PersistentVolumeClaim")),
                  key=lambda p: p["metadata"]["name"])
    moved = pods[0]
    moved["metadata"]["labels"] = {"team": pods[1]["metadata"]["labels"]
                                   .get("team", "t")}
    kube.update(moved)
    ing = ings[0]
    ing["spec"] = copy.deepcopy(ings[1]["spec"])
    kube.update(ing)
    pvc = pvcs[0]
    pvc["spec"]["storageClassName"] = "gone"
    kube.update(pvc)
    kube.delete(("", "v1", "Pod"), pods[2]["metadata"]["name"],
                pods[2]["metadata"]["namespace"])


def _restart(package, width, kube, snap_dir):
    """Restore a fresh client of ``package`` from ``snap_dir`` and sweep
    -> (client, loader, outcome, restored host mask, capped results,
    totals, the first sweep's stats)."""
    if package == "torch":
        client, loader = _torch_client(width), SnapshotLoader(snap_dir)
    else:
        client, loader = _jax_client(width), JaxLoader(snap_dir)
    outcome = loader.restore(client, kube)
    st = client.driver._delta_state
    mask = None
    if st is not None:
        got = st.mask_src.get()
        mask = host_mask(got) if package == "torch" else np.asarray(got)
    resp, totals = client.audit_capped(CAP)
    return {"client": client, "loader": loader, "outcome": outcome,
            "mask": mask, "K": None if st is None else st.K,
            "results": _rendered(resp.results()),
            "sig": syn.audit_result_sig(resp.results()), "totals": totals,
            "sweep": dict(client.driver.last_sweep_stats)}


@pytest.mark.parametrize("corpus,width", [
    ("synthetic", 1), ("synthetic", 2), ("referential", 1),
])
def test_the_port_restores_as_the_jax_package_does(tmp_path, monkeypatch,
                                                   corpus, width):
    monkeypatch.setenv("GK_VIRTUAL_DEVICES", "2")
    objects, churn = {
        "synthetic": (synthetic_corpus(), churn_synthetic),
        "referential": (referential_corpus(), churn_referential),
    }[corpus]
    kubes = {"torch": InMemoryKube(), "jax": JaxKube()}
    for kube in kubes.values():
        for o in objects[2]:
            kube.create(copy.deepcopy(o))
    written = {}
    for package, kube in kubes.items():
        make = _torch_client if package == "torch" else _jax_client
        snapper = Snapshotter if package == "torch" else JaxSnapshotter
        client = _fill(make(width), objects[:2] + (stored(kube),))
        client.audit_capped(CAP)
        got = client.driver._delta_state.mask_src.get()
        written[package] = (host_mask(got) if package == "torch"
                            else np.asarray(got))
        assert snapper(client, str(tmp_path / package),
                       interval_s=0.0).write_once() is not None
        churn(kube)
    np.testing.assert_array_equal(written["torch"], written["jax"])

    t = _restart("torch", width, kubes["torch"], str(tmp_path / "torch"))
    j = _restart("jax", width, kubes["jax"], str(tmp_path / "jax"))
    assert t["outcome"] == j["outcome"] == "restored"
    assert t["loader"].stats == j["loader"].stats
    assert t["loader"].stats["matched"] > 0
    assert t["loader"].delta_restored is j["loader"].delta_restored is True
    # the restored masks: bit-equal to each other and to the writer's,
    # and so are their [C, 1+K] reductions
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_array_equal(t["mask"], written["torch"])
    K = t["K"]
    assert K == j["K"]
    np.testing.assert_array_equal(
        packed_reduction_plain(torch.from_numpy(t["mask"]), K).numpy(),
        np.asarray(_packed_reduction(j["mask"], K)))
    # the first sweep after the restore: the delta path on both, over the
    # same rows, with byte-equal results and equal totals
    assert t["sweep"].get("delta_rows") == j["sweep"].get("delta_rows")
    assert t["sweep"].get("delta_rows", 0) > 0
    assert t["results"] == j["results"]
    assert t["totals"] == j["totals"]
    # uncapped: equal on both, and equal to the oracle's; the capped
    # results a subset of the oracle's, its exact totals equal
    t_all = t["client"].audit().results()
    assert _rendered(t_all) == _rendered(j["client"].audit().results())
    oracle = _fill(JaxClient(driver=InterpDriver()),
                   objects[:2] + (stored(kubes["jax"]),))
    _o_resp, o_totals = oracle.audit_capped(CAP)
    o_all = syn.audit_result_sig(oracle.audit().results())
    assert syn.audit_result_sig(t_all) == o_all
    assert set(t["sig"]) <= set(o_all)
    for key, (n, how) in t["totals"].items():
        if how == "exact":
            assert n == o_totals[key][0], key


# ---- the code fingerprint ---------------------------------------------------


@pytest.fixture()
def package_copy(tmp_path, monkeypatch):
    """The fingerprint taken over a copy of the port's sources, which the
    test may edit."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(sealmod.__file__)))
    dst = tmp_path / "gatekeeper_tpu_torch"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.so"))
    monkeypatch.setattr(sealmod, "__file__",
                        str(dst / "util" / "seal.py"))
    monkeypatch.setattr(sealmod, "_code_fp", None)
    yield dst
    sealmod._code_fp = None


@pytest.mark.parametrize("edited", ["kernels/match.cu",
                                    "kernels/strpred.cuh"])
@pytest.mark.parametrize("keyed", [False, True])
def test_an_edited_kernel_source_makes_an_older_snapshot_fall_back(
        package_copy, snap_dir, monkeypatch, edited, keyed):
    """The fingerprint hashes the kernels' sources: a snapshot written
    before a .cu or .cuh edit falls back after it, rejected by its seal
    (the default key derives from the fingerprint) or, under a real
    GK_SEAL_KEY, by the manifest's fingerprint."""
    if keyed:
        monkeypatch.setenv("GK_SEAL_KEY", "a-deployment-secret")
    before = sealmod.code_fingerprint()
    kube = build_cluster(n=6)
    client = make_client(kube)
    audit_sig(client)
    assert Snapshotter(client, snap_dir).write_once() is not None
    # unedited, the snapshot restores
    assert SnapshotLoader(snap_dir).restore(fresh_client(), kube) == \
        "restored"
    path = package_copy / edited
    path.write_text(path.read_text() + "\n// edited\n")
    sealmod._code_fp = None
    assert sealmod.code_fingerprint() != before
    fallbacks = outcome_counts().get("fallback", 0)
    assert SnapshotLoader(snap_dir).restore(fresh_client(), kube) == \
        "fallback"
    assert outcome_counts().get("fallback", 0) == fallbacks + 1
    assert os.listdir(os.path.join(snap_dir, snapfmt.QUARANTINE_DIR))


def test_the_fingerprint_reads_sources_only(package_copy):
    before = sealmod.code_fingerprint()
    (package_copy / "kernels" / "notes.txt").write_text("not a source")
    sealmod._code_fp = None
    assert sealmod.code_fingerprint() == before
