"""The port's numpy host tier (ops/npside.py over ops/npeval.py, served by
TorchDriver._np_review) held to the device path and to the JAX package.

Its masks must equal the port's compute_masks (the plain versions on the
CPU) cell for cell, and TpuDriver's numpy side (``_np_side.serve``) on the
same reviews, on four corpora: the synthetic one, the render corpus (every
node kind a template produces), the referential one (JoinCmp unbound on a
review) and one whose constraints carry live label and namespace
selectors.  Every verdict it serves equals the InterpDriver oracle's.  Then
tests/test_npside.py's classes on the port: mask parity, incremental sync
(updates, removals, template re-puts, orphans, change-log overrun),
selectors, an ingest storm and the interpreter's GVK walk list; last, a
warm-restored App's first numpy serve.  Every output is bool or a verdict:
compared exactly."""

import copy

import numpy as np
import pytest

from gatekeeper_tpu.client import Client as JClient
from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu_torch.client import Client
from gatekeeper_tpu_torch.client.drivers import InterpDriver
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.util import matchcorpus
from gatekeeper_tpu_torch.util import synthetic as syn

from .render_corpus import corpus, resources
from .test_client_conformance import (
    DENY_REGO,
    PARAM_REGO,
    make_constraint,
    make_object,
    make_template,
)


def pod_req(pod, i):
    return {
        "uid": str(i),
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "name": pod["metadata"]["name"],
        "namespace": "default",
        "operation": "CREATE",
        "object": pod,
    }


def obj_req(obj, i):
    """An admission request for any stored object."""
    api = obj.get("apiVersion", "v1")
    group, _, version = api.rpartition("/")
    md = obj.get("metadata", {})
    return {
        "uid": f"u{i}",
        "kind": {"group": group, "version": version, "kind": obj["kind"]},
        "name": md.get("name", ""),
        "namespace": md.get("namespace", ""),
        "operation": "CREATE",
        "object": obj,
    }


def masks_equal(driver, reviews):
    """The numpy side's masks equal compute_masks' cell for cell ->
    (ordered, mask, autoreject) of the numpy side."""
    with driver._lock:
        ordered_d, mask_d, rej_d = driver.compute_masks(
            copy.deepcopy(reviews))
        driver._np_side.sync(driver)
        got = driver._np_side.serve(driver, copy.deepcopy(reviews))
        assert got is not None
        ordered_n, mask_n, rej_n = got
    assert [o[:2] for o in ordered_d] == [o[:2] for o in ordered_n]
    R = mask_n.shape[1]
    assert R == len(reviews)
    np.testing.assert_array_equal(mask_d[:, :R], mask_n)
    np.testing.assert_array_equal(rej_d[:, :R], rej_n)
    return got


def np_only(driver):
    """Route every admission batch to the numpy tier."""
    driver.DEVICE_MIN_CELLS = 10**9
    driver.NP_MIN_CELLS = 0
    return driver


@pytest.fixture
def driver():
    return np_only(TorchDriver(device="cpu"))


# ---- the corpora, against the device path and TpuDriver's numpy side ------


def _selector_corpus():
    """Deny-all templates whose constraints carry matchcorpus's match
    specs (label and namespace selectors, namespaces, scopes), with its
    namespaces stored (ns-b stays uncached: autoreject) and its reviews."""
    raw, reviews = matchcorpus.make_corpus(4, 10, 16)
    templates = [make_template(kind="Foo", rego=DENY_REGO),
                 make_template(kind="Bar", rego=PARAM_REGO)]
    constraints = []
    for i, c in enumerate(raw[:-2]):  # the last two are pad rows
        kind = "Foo" if i % 2 else "Bar"
        spec = {"match": (c.get("spec") or {}).get("match", {}),
                "parameters": {"name": f"pod-{i}"}}
        constraints.append({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": f"sel-{i}"}, "spec": spec})
    objs = [{"apiVersion": "v1", "kind": "Namespace",
             "metadata": dict(ns["metadata"])}
            for ns in matchcorpus.NAMESPACES.values()]
    return templates, constraints, objs, reviews


def _corpus(name):
    """(templates, constraints, stored objects, admission reviews)."""
    if name == "synthetic":
        templates, constraints = syn.make_templates(24, seed=3)
        pods = syn.make_pods(12, seed=3, violation_rate=0.5)
        return templates, constraints, [], [pod_req(p, i)
                                             for i, p in enumerate(pods)]
    if name == "render":
        entries = corpus()
        objs = resources()
        return ([t for _n, t, _c, _tier in entries],
                [c for _n, _t, c, _tier in entries], [],
                [obj_req(o, i) for i, o in enumerate(objs)])
    if name == "referential":
        templates, constraints = syn.make_referential_templates(6)
        objs = syn.make_referential_objects(60, 1)
        return templates, constraints, objs, [obj_req(o, i) for i, o
                                              in enumerate(objs[:24])]
    return _selector_corpus()


def _load(client, templates, constraints, objs):
    for t in templates:
        client.add_template(copy.deepcopy(t))
    for k in constraints:
        client.add_constraint(copy.deepcopy(k))
    for o in objs:
        client.add_data(copy.deepcopy(o))
    return client


def _sig(responses):
    return [[(r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
              r.enforcement_action) for r in x.results()] for x in responses]


CORPORA = ["synthetic", "render", "referential", "selectors"]


@pytest.mark.parametrize("name", CORPORA)
def test_masks_equal_the_device_path_and_the_jax_numpy_side(name):
    templates, constraints, objs, reviews = _corpus(name)
    port = _load(Client(driver=np_only(TorchDriver(device="cpu"))),
                 templates, constraints, objs)
    tpu = TpuDriver()
    tpu.mesh_enabled = False
    _load(JClient(driver=tpu), templates, constraints, objs)
    for batch in ([r] for r in reviews[:4]), [reviews]:
        for rs in batch:
            ordered, mask, rej = masks_equal(port.driver, rs)
            with tpu._lock:
                tpu._np_side.sync(tpu)
                want = tpu._np_side.serve(tpu, copy.deepcopy(rs))
            assert [o[:2] for o in ordered] == [o[:2] for o in want[0]]
            np.testing.assert_array_equal(mask, want[1])
            np.testing.assert_array_equal(rej, want[2])
    _o, mask, rej = masks_equal(port.driver, reviews)
    assert mask.any()
    if name == "selectors":
        assert rej.any() and not mask.all()


@pytest.mark.parametrize("name", CORPORA)
def test_the_numpy_tier_serves_the_oracles_verdicts(name):
    templates, constraints, objs, reviews = _corpus(name)
    port = _load(Client(driver=np_only(TorchDriver(device="cpu"))),
                 templates, constraints, objs)
    oracle = _load(Client(driver=InterpDriver()), templates, constraints,
                   objs)
    d = port.driver
    d.route_ledger.clear()
    got = _sig(port.review_batch(copy.deepcopy(reviews[:8])))
    got += _sig([port.review(copy.deepcopy(r)) for r in reviews[8:]])
    want = _sig(oracle.review_batch(copy.deepcopy(reviews)))
    assert got == want
    tiers = {e["tier"] for e in d.route_ledger.snapshot()["decisions"]}
    assert tiers == {"np"}


# ---- tests/test_npside.py on the port ----------------------------------------


class TestMaskParity:
    def test_synthetic_corpus(self, driver):
        templates, constraints = syn.make_templates(60)
        _load(Client(driver=driver), templates, constraints, [])
        for i, p in enumerate(syn.make_pods(12, seed=3)):
            masks_equal(driver, [pod_req(p, i)])

    def test_vocab_growth_between_serves(self, driver):
        """Strings a later review interns must be in the predicate mats
        before the gather (extract_columns, not pack_reviews, interns the
        program columns)."""
        templates, constraints = syn.make_templates(24)
        _load(Client(driver=driver), templates, constraints, [])
        with driver._lock:
            driver._np_side.sync(driver)
        for i, p in enumerate(syn.make_pods(10, seed=11,
                                            violation_rate=0.0)):
            out, _trace = driver.review(pod_req(p, i))
            # compliant pods draw no violation; a stale predicate table
            # shows as false image-prefix renders
            assert out == []
        assert driver.route_ledger.last()[0] == "np"

    def test_batch_of_multiple_reviews(self, driver):
        templates, constraints = syn.make_templates(12)
        _load(Client(driver=driver), templates, constraints, [])
        pods = syn.make_pods(6, seed=5)
        masks_equal(driver, [pod_req(p, i) for i, p in enumerate(pods)])


class TestIncrementalSync:
    def test_constraint_update_changes_params(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template(rego=PARAM_REGO))
        c.add_constraint(make_constraint(params={"name": "alpha"}))
        assert len(c.review(make_object("alpha")).results()) == 1
        c.add_constraint(make_constraint(params={"name": "beta"}))
        assert c.review(make_object("alpha")).results() == []
        assert len(c.review(make_object("beta")).results()) == 1

    def test_constraint_remove(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template())
        c.add_constraint(make_constraint(name="a", params={"name": "x"}))
        c.add_constraint(make_constraint(name="b", params={"name": "x"}))
        assert len(c.review(make_object("x")).results()) == 2
        c.remove_constraint(make_constraint(name="a"))
        out = c.review(make_object("x")).results()
        assert len(out) == 1
        assert out[0].constraint["metadata"]["name"] == "b"

    def test_template_reput_changes_program(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template(rego=PARAM_REGO))
        c.add_constraint(make_constraint(params={"name": "x"}))
        assert len(c.review(make_object("x")).results()) == 1
        inverted = """
package foo
violation[{"msg": msg}] {
  input.review.object.metadata.name != input.parameters.name
  msg := "name mismatch"
}
"""
        c.add_template(make_template(rego=inverted))
        assert c.review(make_object("x")).results() == []
        assert len(c.review(make_object("y")).results()) == 1

    def test_template_remove_then_constraint_orphan(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template())
        c.add_constraint(make_constraint(params={"name": "x"}))
        c.remove_template(make_template())
        assert c.review(make_object("x")).results() == []

    def test_delete_template_purges_caches(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template())
        c.add_constraint(make_constraint(
            params={"name": "x"},
            match={"namespaceSelector": {"matchLabels": {"env": "prod"}}},
        ))
        assert len(c.review(make_object("x")).results()) >= 1
        c.remove_template(make_template())
        assert c.review(make_object("x")).results() == []
        assert driver._ordered_constraints() == []
        assert not driver._memoable_false
        with driver._lock:
            assert driver._memoable_synced() is True

    def test_explicit_null_kinds_is_wildcard(self, driver):
        """match: {kinds: null} is the wildcard (the oracle reads it so);
        the GVK walk list must not skip such a constraint."""
        c = Client(driver=driver)
        c.add_template(make_template())
        c.add_constraint(make_constraint(params={"name": "x"},
                                         match={"kinds": None}))
        ci = Client(driver=InterpDriver())
        ci.add_template(make_template())
        ci.add_constraint(make_constraint(params={"name": "x"},
                                          match={"kinds": None}))
        out = c.review(make_object("x")).results()
        want = ci.review(make_object("x")).results()
        assert [r.msg for r in out] == [r.msg for r in want]
        assert len(out) == 1
        # the interpreter's walk too, on fresh content (no memo replay)
        driver.np_serve_enabled = False
        assert [r.msg for r in c.review(make_object("zzz")).results()] == \
            ["DENIED"]
        assert driver.route_ledger.last() == ("interp", "uncalibrated_prior")
        assert len(driver._gvk_walk_list(
            {"kind": {"group": "", "kind": "ConfigMap"}})) == 1

    def test_change_log_overrun_rebuilds(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template())
        c.add_constraint(make_constraint(params={"name": "x"}))
        c.review(make_object("x"))
        rebuilt = []
        side = driver._np_side
        orig = side._rebuild
        side._rebuild = lambda d: rebuilt.append(d) or orig(d)
        # a long-disconnected side: the floor past it
        with driver._lock:
            driver._cs_log_floor = driver._cs_epoch + 100
            driver._cs_epoch += 100
        out = c.review(make_object("x2", labels={"a": "b"})).results()
        assert rebuilt == [driver] and len(out) == 1
        assert driver.route_ledger.last()[0] == "np"


class TestSelectors:
    def test_label_selector_still_exact(self, driver):
        """The fast path skips the selector algebra only when every row's
        selector is empty; a real selector still evaluates."""
        c = Client(driver=driver)
        c.add_template(make_template())
        c.add_constraint(make_constraint(
            params={"name": "x"},
            match={"labelSelector": {"matchLabels": {"team": "a"}}},
        ))
        assert len(c.review(make_object("x", labels={"team": "a"}))
                   .results()) == 1
        assert c.review(make_object("x", labels={"team": "b"})) \
            .results() == []

    def test_namespace_selector_autoreject(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template())
        match = {"namespaceSelector": {"matchLabels": {"env": "prod"}}}
        c.add_constraint(make_constraint(params={"name": "zzz"},
                                         match=match))
        ci = Client(driver=InterpDriver())
        ci.add_template(make_template())
        ci.add_constraint(make_constraint(params={"name": "zzz"},
                                          match=match))
        out = c.review(make_object("anything")).results()
        want = ci.review(make_object("anything")).results()
        assert [r.msg for r in out] == [r.msg for r in want]
        assert "Namespace is not cached in OPA." in [r.msg for r in out]


class TestStorm:
    def test_interleaved_unique_reviews_stay_correct(self, driver):
        """Serves in the middle of an ingest storm (every add bumps the
        epoch, the side syncs one constraint at a time) equal the oracle
        over the templates installed by then."""
        templates, constraints = syn.make_templates(40)
        c = Client(driver=driver)
        pods = syn.make_pods(40, seed=13)
        synced = []
        sync = driver._np_side.sync
        driver._np_side.sync = lambda d: synced.append(d._cs_epoch) or \
            sync(d)
        seen = []
        for i, (t, k) in enumerate(zip(templates, constraints)):
            c.add_template(t)
            c.add_constraint(k)
            out, _ = driver.review(pod_req(pods[i], i))
            seen.append(sorted(
                (r.constraint["kind"], r.constraint["metadata"]["name"],
                 r.msg) for r in out))
        assert len(synced) == len(templates)
        oracle = InterpDriver()
        for kind, tmpl in driver.templates.items():
            oracle.put_template(kind, tmpl)
        for kind, by_name in driver.constraints.items():
            for name, cs in by_name.items():
                oracle.put_constraint(kind, name, cs)
        for i, p in enumerate(pods):
            want = sorted(
                (r.constraint["kind"], r.constraint["metadata"]["name"],
                 r.msg)
                for r in oracle.review(pod_req(p, i))[0])
            installed = {t["spec"]["crd"]["spec"]["names"]["kind"]
                         for t in templates[: i + 1]}
            assert seen[i] == [w for w in want if w[0] in installed]


class TestGvkPrefilter:
    def test_walk_list_prunes_unrelated_kinds(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template())
        c.add_constraint(make_constraint(
            params={"name": "x"},
            match={"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
        ))
        pod_review = {"uid": "1", "kind": {"group": "", "kind": "Pod"},
                      "name": "p", "operation": "CREATE",
                      "object": {"kind": "Pod", "metadata": {"name": "p"}}}
        cm_review = {"uid": "2", "kind": {"group": "", "kind": "ConfigMap"},
                     "name": "m", "operation": "CREATE",
                     "object": {"kind": "ConfigMap",
                                "metadata": {"name": "m"}}}
        assert len(driver._gvk_walk_list(pod_review)) == 1
        assert driver._gvk_walk_list(cm_review) == []

    def test_wildcards_and_nssel_kept(self, driver):
        c = Client(driver=driver)
        c.add_template(make_template())
        c.add_constraint(make_constraint(
            name="wild", params={"name": "x"},
            match={"kinds": [{"apiGroups": ["*"], "kinds": ["*"]}]},
        ))
        c.add_constraint(make_constraint(
            name="nssel", params={"name": "x"},
            match={"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
                   "namespaceSelector": {"matchLabels": {"a": "b"}}},
        ))
        review = {"uid": "1", "kind": {"group": "apps",
                                       "kind": "Deployment"},
                  "name": "d", "operation": "CREATE",
                  "object": {"kind": "Deployment",
                             "metadata": {"name": "d"}}}
        names = [n for _k, n, _c in driver._gvk_walk_list(review)]
        # the wildcard matches every kind; nssel rides along (autoreject)
        assert names == ["nssel", "wild"]

    @pytest.mark.parametrize("name", CORPORA)
    def test_interp_walk_matches_oracle_with_prefilter(self, driver, name):
        """The interpreter's walk (numpy tier off) against the oracle on
        every corpus, mixed kinds included; it visits no more than the
        walk list."""
        driver.np_serve_enabled = False
        templates, constraints, objs, reviews = _corpus(name)
        c = _load(Client(driver=driver), templates, constraints, objs)
        oracle = _load(Client(driver=InterpDriver()), templates,
                       constraints, objs)
        walked = []
        walk = driver._walk_one
        driver._walk_one = lambda results, kind, constraint, *a, **kw: (
            walked.append(constraint["metadata"]["name"])
            or walk(results, kind, constraint, *a, **kw))
        for r in reviews:
            got = _sig([c.review(copy.deepcopy(r))])
            assert got == _sig([oracle.review(copy.deepcopy(r))])
            assert driver.route_ledger.last()[0] == "interp"
        assert walked and len(walked) <= len(reviews) * len(constraints)


# ---- a warm-restored App's first numpy serve ------------------------------


@pytest.mark.parametrize("resync", [True, False])
def test_a_restored_apps_first_numpy_serve(tmp_path, monkeypatch, resync):
    """App 1 writes a snapshot; App 2 restores it (and with
    --snapshot-no-resync keeps the restored inventory as it is).  Its
    numpy side is built on its first serve from the restored constraint
    side: the masks equal compute_masks', and the verdicts, served by the
    numpy tier, equal App 1's device answers for the same pods."""
    from .test_torch_app import (
        SEEDS,
        SERVED,
        TorchApp,
        _args,
        _ready,
        _small_store,
        _synced,
    )

    # neither App calibrates in the background (forced device), so
    # nothing syncs the numpy side before the serve below
    monkeypatch.setattr(TorchDriver, "DEVICE_MIN_CELLS", 0)
    kube, _kinds = _small_store()
    snap = str(tmp_path / "snapshots")
    pods = syn.make_pods(6, SEEDS[4], violation_rate=0.7)
    reviews = []
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"np-restored-{i}"
        p["metadata"]["namespace"] = SERVED[i % len(SERVED)]
        reviews.append(obj_req(p, i))

    def app_for(name, *flags):
        return TorchApp(_args("--torch-device", "cpu", "--cert-dir",
                              str(tmp_path / name), "--snapshot-dir", snap,
                              "--snapshot-interval", "86400", *flags),
                        kube=kube)

    first = app_for("first")
    first.start()
    try:
        first.snapshotter.stop()
        assert _ready(first)
        _synced(first, kube)
        assert first.audit_manager.run_once_guarded()
        want = _sig(first.client.review_batch(copy.deepcopy(reviews)))
        assert first.client.driver.route_ledger.last()[0] == "device"
        assert first.snapshotter.write_once() is not None
    finally:
        first.stop()

    second = app_for("second", *(() if resync else ("--snapshot-no-resync",)))
    second.start()
    try:
        assert second.snapshot_restore_outcome == "restored"
        second.snapshotter.stop()
        assert _ready(second)
        driver = second.client.driver
        assert driver._np_side.last_epoch == -1  # never synced yet
        masks_equal(driver, reviews)
        np_only(driver)
        assert _sig(second.client.review_batch(copy.deepcopy(reviews))) \
            == want
        assert driver.route_ledger.last() == ("np", "uncalibrated_prior")
    finally:
        second.stop()
