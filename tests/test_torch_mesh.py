"""The port's sharded audit sweep (gatekeeper_tpu_torch/parallel/mesh.py and
TorchDriver's mesh seam) on a virtual mesh of the CPU, against the port at
width 1, TpuDriver on the conftest's 8-device CPU mesh, and the
InterpDriver oracle.

GK_VIRTUAL_DEVICES=8 gives visible_devices() eight slots of the CPU, the
counterpart of the conftest's --xla_force_host_platform_device_count=8.
Widths 1, 2, 3 (never dividing the power-of-two row bucket), 4 and 8, and
rows fewer than the width, give results, totals and [C, 1+K] reductions
equal byte for byte.  This mirrors tests/test_mesh.py and
tests/test_mesh_sharding.py.  Tolerance 0 throughout: every compared value
is a bool, an int or a rendered string.
"""

import copy
import json
import threading

import numpy as np
import pytest
import torch

from gatekeeper_tpu.client.client import Client as JaxClient
from gatekeeper_tpu.client.drivers import InterpDriver
from gatekeeper_tpu.engine.value import thaw as jthaw
from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu.util import synthetic as jsyn
from gatekeeper_tpu_torch.client.client import Client as TorchClient
from gatekeeper_tpu_torch.engine.value import thaw
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.parallel import mesh as pm
from gatekeeper_tpu_torch.util import synthetic as syn

CAP = 100  # above every per-constraint count: totals exact on all tiers
sig = syn.audit_result_sig
WIDTHS = (1, 2, 3, 4, 8)


@pytest.fixture(autouse=True)
def _virtual_mesh(monkeypatch):
    monkeypatch.setenv(pm.VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.delenv("GK_MESH", raising=False)


def _port(n_templates, n_resources, width, seed=0):
    client = syn.build_driver(n_templates, n_resources, seed, device="cpu")
    client.driver.set_mesh(True, width=width)
    client.driver.DEVICE_MIN_CELLS = 0  # reviews take the device path
    return client


def _reviews(driver):
    return [
        driver.target.make_audit_review(thaw(o), api, k, n, ns)
        for o, api, k, n, ns in driver.store.iter_objects()
    ]


def _sweep(client, cap=CAP):
    """A capped sweep -> (results signature, totals, [C] counts, [C, K]
    first candidates, stats)."""
    resp, totals = client.audit_capped(cap)
    stats = dict(client.driver.last_sweep_stats)
    _r, _o, _m, counts, topk = client.driver._audit_cache[1]
    return sig(resp.results()), totals, counts, topk, stats


def _same_sweep(a, b):
    assert a[0] == b[0]
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[2], b[2])
    assert a[3].shape == b[3].shape
    np.testing.assert_array_equal(a[3], b[3])


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------


def test_visible_devices_gives_virtual_slots(monkeypatch):
    assert pm.visible_devices("cpu") == (torch.device("cpu"),) * 8
    monkeypatch.delenv(pm.VIRTUAL_DEVICES_ENV)
    assert pm.visible_devices("cpu") == (torch.device("cpu"),)
    assert pm.maybe_audit_mesh("cpu") is None
    for bad in ("0", "two", "-3"):
        monkeypatch.setenv(pm.VIRTUAL_DEVICES_ENV, bad)
        with pytest.raises(ValueError):
            pm.visible_devices("cpu")


def test_audit_mesh_widths():
    assert pm.maybe_audit_mesh("cpu").devices.size == 8
    mesh = pm.audit_mesh(3, "cpu")
    assert mesh.devices.size == 3
    assert mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(RuntimeError):
        pm.audit_mesh(9, "cpu")


def test_pad_rows_slabs_and_owning_shards():
    assert pm.pad_rows(8, 8) == 8
    assert pm.pad_rows(8, 3) == 9
    assert pm.pad_rows(9, 8) == 16
    assert pm.pad_rows(1, 8) == 8
    assert pm.slab_rows(16, 3) == (18, 6)
    assert pm.owning_shards([0, 5, 6, 17], 16, 3) == {0, 1, 2}
    x = np.arange(10).reshape(5, 2)
    np.testing.assert_array_equal(pm._slab_of(x, 4, 7),
                                  [[8, 9], [0, 0], [0, 0]])
    assert np.shares_memory(pm._slab_of(x, 0, 2), x)  # in range: a view


@pytest.mark.parametrize("pipelined", [False, True])
def test_slab_commit_cuts_pads_and_replicates(monkeypatch, pipelined):
    """Row-major leaves in contiguous zero-padded slabs, one a shard,
    copies of the host arrays; other leaves placed once per device.
    With PIPELINE_MIN_SLAB_ROWS lowered the packer thread runs."""
    if pipelined:
        monkeypatch.setattr(pm, "PIPELINE_MIN_SLAB_ROWS", 0)
    rows = 10
    rng = np.random.default_rng(0)
    rv = {"valid": rng.random(rows) < 0.7,
          "ids": rng.integers(0, 9, (rows, 3)).astype(np.int32)}
    cols = {("c",): {"sid": np.arange(rows, dtype=np.int32),
                     "table": np.ones(4, np.uint8)}}
    mesh = pm.audit_mesh(4, "cpu")
    shards, target = pm.shard_review_side(mesh, rows, rv, cols)
    assert target == 12 and len(shards) == 4
    for s, (srv, scols) in enumerate(shards):
        lo = 3 * s
        want = pm._slab_of(rv["ids"], lo, lo + 3)
        np.testing.assert_array_equal(srv["ids"].numpy(), want)
        assert srv["valid"].shape == (3,)
        np.testing.assert_array_equal(
            scols[("c",)]["sid"].numpy(),
            pm._slab_of(cols[("c",)]["sid"], lo, lo + 3))
        assert scols[("c",)]["table"] is shards[0][1][("c",)]["table"]
    assert not shards[3][0]["valid"][1:].any()  # the padded tail
    rv["ids"][0] = -7  # the host pack changes in place: the slab must not
    assert int(shards[0][0]["ids"][0, 0]) != -7


def test_staging_refills_a_slot_only_after_its_copy(monkeypatch):
    """The card's slab commit reuses two pinned slots: a slot is refilled
    only once the committing thread has recorded its copy's event, and
    after that event has completed (an asynchronous copy reads the slot
    when the card gets to it).  The event and the pinned buffer have CPU
    stand-ins."""
    events = []

    class Event:
        def __init__(self):
            self.synced = False
            events.append(self)

        def record(self, stream):
            pass

        def synchronize(self):
            self.synced = True

    monkeypatch.setattr(pm, "pinned_empty",
                        lambda n: torch.empty(n, dtype=torch.uint8))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: None)
    leaves = [np.arange(12, dtype=np.int32).reshape(6, 2),
              np.array([True, False, True, True, False, False]),
              np.arange(6, dtype=np.float64)]
    st = pm._Staging(leaves, 3)
    stop = threading.Event()
    views = st.fill(0, [pm._slab_of(x, 0, 3) for x in leaves], stop)
    for v, x in zip(views, leaves):
        np.testing.assert_array_equal(v.numpy(), x[:3])
    got = []
    refill = threading.Thread(target=lambda: got.append(st.fill(
        0, [pm._slab_of(x, 3, 6) for x in leaves], stop)))
    refill.start()
    refill.join(0.3)
    assert refill.is_alive() and not got  # slot 0's copy not recorded yet
    st.copied_out(0, torch.device("cpu"))
    refill.join(5)
    assert not refill.is_alive() and events[0].synced
    for v, x in zip(got[0], leaves):
        np.testing.assert_array_equal(v.numpy(), x[3:])
    stop.set()  # a waiter gives up once the commit stops
    assert st.fill(0, [], stop) is None


def test_replicate_tree_places_once_per_device():
    mesh = pm.audit_mesh(4, "cpu")
    placed = pm.replicate_tree(mesh, {"a": np.arange(3)})
    assert len(placed) == 4 and all(p is placed[0] for p in placed)
    got = pm.shard_args(mesh, 4, ({"v": np.ones(4, bool)},
                                  {"c": np.arange(2)}, {}, []))
    args, target = got
    assert target == 4 and args[0][1] is args[3][1]


def test_dispatch_gate_revoke_lets_the_next_holder_in():
    gate = pm.DispatchGate()
    token = gate.acquire()
    assert gate.acquire(timeout=0.05) is None  # busy
    gate.revoke()
    second = gate.acquire(timeout=1.0)
    assert second is not None and gate.revocations == 1
    gate.release(token)  # the abandoned holder's late release is harmless
    gate.release(second)
    with gate:
        assert gate.locked()
    assert not gate.locked()


# ---------------------------------------------------------------------------
# sharded masks and counts (tests/test_mesh.py)
# ---------------------------------------------------------------------------


def _workload(n_templates=8, n_resources=40):
    tclient = syn.build_driver(n_templates, n_resources, device="cpu")
    jclient = jsyn.build_driver(n_templates, n_resources)
    jd = jclient.driver
    jreviews = [
        jd.target.make_audit_review(jthaw(o), api, k, n, ns)
        for o, api, k, n, ns in jd.store.iter_objects()
    ]
    return tclient.driver, _reviews(tclient.driver), jd, jreviews


@pytest.mark.parametrize("width", [3, 8])
def test_sharded_masks_bit_parity(width):
    """Width 3 never divides the row bucket: the padding path end to end.
    Equal to the port's single-device masks and to TpuDriver's on its
    8-device mesh."""
    td, reviews, jd, jreviews = _workload()
    td.set_mesh(False)  # the single-device reference
    o1, mask1, rej1 = td.compute_masks(reviews)
    o2, mask2, rej2 = pm.sharded_masks(td, reviews, pm.audit_mesh(width,
                                                                  "cpu"))
    assert [k for k, _n, _c in o1] == [k for k, _n, _c in o2]
    np.testing.assert_array_equal(mask1, mask2)
    np.testing.assert_array_equal(rej1, rej2)
    _o3, jmask, jrej = jd.compute_masks(jreviews)
    np.testing.assert_array_equal(mask2, jmask)
    np.testing.assert_array_equal(rej2, jrej)
    assert mask2.any()


def test_sharded_violation_counts_match_mask_sums():
    td, reviews, _jd, _jr = _workload()
    td.set_mesh(False)
    _o, mask, rej = td.compute_masks(reviews)
    _o2, counts, rejects = pm.sharded_violation_counts(
        td, reviews, pm.audit_mesh(8, "cpu"))
    np.testing.assert_array_equal(counts, mask.sum(axis=1))
    np.testing.assert_array_equal(rejects, rej.sum(axis=1))
    assert counts.sum() > 0


# ---------------------------------------------------------------------------
# admission reviews under the mesh (compute_masks' mesh branch)
# ---------------------------------------------------------------------------


def _review_pods(n):
    pods = syn.make_pods(n, seed=7, violation_rate=0.5)
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"mesh-review-{i}"
    return pods


def _review_sig(responses):
    """Every result of every review, in order, as bytes: constraint,
    message, enforcement action and metadata."""
    return [
        [json.dumps([r.constraint["kind"], r.constraint["metadata"]["name"],
                     r.msg, r.enforcement_action, r.metadata],
                    sort_keys=True, default=str)
         for r in resp.results()]
        for resp in responses
    ]


@pytest.fixture(scope="module")
def review_refs():
    """For a batch of 1 review (8 rows) and of 9 (16 rows): the port's
    masks on one device, equal to TpuDriver's on the conftest's 8-device
    mesh, and the oracle's review results, equal to the port's."""
    port = syn.build_driver(8, 40, device="cpu")
    assert port.driver._mesh() is None
    tpu = jsyn.build_driver(8, 40)
    oracle = jsyn.build_oracle(8, 40)
    out = {}
    for n in (1, 9):
        pods = _review_pods(n)
        reviews = [port.driver.target.handle_review(p)[1] for p in pods]
        masks = port.driver.compute_masks(reviews)
        _o, jmask, jrej = tpu.driver.compute_masks(copy.deepcopy(reviews))
        np.testing.assert_array_equal(masks[1], jmask)
        np.testing.assert_array_equal(masks[2], jrej)
        want = _review_sig(oracle.review_batch(copy.deepcopy(pods)))
        assert _review_sig(port.review_batch(copy.deepcopy(pods))) == want
        assert any(want)
        out[n] = (pods, reviews, masks, want)
    return out


@pytest.mark.parametrize("n", [1, 9])
@pytest.mark.parametrize("width", [2, 3, 4, 8])
def test_reviews_under_the_mesh_equal_width_1(width, n, review_refs,
                                              monkeypatch):
    """compute_masks and review_batch at every width: each shard packs
    its slab (K10's plain version, once a shard) and the host unpacks
    each slab on its own.  R = 8 at width 4 is a slab of 2 rows, and
    widths 3 and 8 give slabs of 3, 6, 1 and 2 rows: none a multiple of
    8, so the pad bits of each slab's last byte must drop out."""
    from gatekeeper_tpu_torch.ops import packbits

    pods, reviews, (o1, mask1, rej1), want = review_refs[n]
    client = _port(8, 40, width)
    driver = client.driver
    assert driver.mesh_layout() == width
    calls = []
    orig = packbits.pack_review_masks_plain
    monkeypatch.setattr(
        packbits, "pack_review_masks_plain",
        lambda m, a: calls.append(tuple(m.shape)) or orig(m, a))
    o2, mask2, rej2 = driver.compute_masks(reviews)
    rows = mask1.shape[1]
    slab = pm.slab_rows(rows, width)[1]
    C = driver._constraint_side()[1].arrays["valid"].shape[0]
    assert calls == [(C, slab)] * width
    assert [o[:2] for o in o2] == [o[:2] for o in o1]
    assert mask2.shape == mask1.shape
    np.testing.assert_array_equal(mask2, mask1)
    np.testing.assert_array_equal(rej2, rej1)
    calls.clear()
    assert _review_sig(client.review_batch(copy.deepcopy(pods))) == want
    assert len(calls) == width


# ---------------------------------------------------------------------------
# the sweep at every width, against width 1, TpuDriver and the oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synthetic_refs():
    """Width 1 of the port, TpuDriver on the conftest's 8-device mesh and
    the oracle, capped and uncapped, over one synthetic corpus."""
    port = _port(8, 100, 1)
    tpu = jsyn.build_driver(8, 100)
    assert tpu.driver._mesh() is not None  # the 8-device mesh serves it
    oracle = jsyn.build_oracle(8, 100)
    capped = _sweep(port)
    jr, jt = tpu.audit_capped(CAP)
    orr, ot = oracle.audit_capped(CAP)
    assert capped[0] == sig(jr.results()) == sig(orr.results())
    assert capped[1] == jt == ot
    uncapped = sig(port.audit().results())
    assert uncapped == sig(tpu.audit().results()) == \
        sig(oracle.audit().results())
    return capped, uncapped


@pytest.mark.parametrize("width", WIDTHS)
def test_capped_and_uncapped_sweeps_equal_at_every_width(width,
                                                         synthetic_refs):
    capped, uncapped = synthetic_refs
    client = _port(8, 100, width)
    got = _sweep(client)
    _same_sweep(got, capped)
    assert got[4]["shards"] == float(width)
    # the warm sweep: the cache, then a forced full sweep on the resident
    # slabs
    _same_sweep(_sweep(client), capped)
    client.driver._delta_state = None
    client.driver._audit_cache = None
    again = _sweep(client)
    _same_sweep(again, capped)
    assert again[4]["upload_bytes"] == 0.0
    assert sig(client.audit().results()) == uncapped


@pytest.mark.parametrize("width", [4, 8])
def test_rows_fewer_than_the_width(width):
    """3 live rows across the mesh: most shards hold only padding
    (valid=False rows) and contribute nothing."""
    pair = (_port(6, 3, width), syn.build_oracle(6, 3))
    single = _port(6, 3, 1)
    got = _sweep(pair[0])
    _same_sweep(got, _sweep(single))
    ro, to = pair[1].audit_capped(CAP)
    assert got[0] == sig(ro.results()) and got[1] == to
    assert got[4]["shards"] == float(width)


@pytest.fixture(scope="module")
def join_refs():
    """The referential corpora through the oracle and TpuDriver on the
    8-device mesh: (corpus, capped signature, totals, uncapped)."""
    from .render_corpus import join_corpus

    entries = join_corpus()
    corpora = {
        "join_corpus": ([t for _n, t, _c, _o in entries],
                        [c for _n, _t, c, _o in entries],
                        [o for *_x, objs in entries for o in objs]),
        "synthetic": (*jsyn.make_referential_templates(6, 0),
                      jsyn.make_referential_objects(200, 1)),
    }
    out = {}
    for name, corpus in corpora.items():
        tpu = _load(JaxClient(driver=TpuDriver()), corpus)
        oracle = _load(JaxClient(driver=InterpDriver()), corpus)
        jr, jt = tpu.audit_capped(CAP)
        orr, ot = oracle.audit_capped(CAP)
        assert sig(jr.results()) == sig(orr.results()) and jt == ot
        uncapped = sig(oracle.audit().results())
        assert sig(tpu.audit().results()) == uncapped
        out[name] = (corpus, sig(orr.results()), ot, uncapped)
    return out


def _load(client, corpus):
    templates, constraints, objs = corpus
    for t in templates:
        client.add_template(copy.deepcopy(t))
    for k in constraints:
        client.add_constraint(copy.deepcopy(k))
    for o in objs:
        client.add_data(copy.deepcopy(o))
    return client


@pytest.mark.parametrize("corpus", ["join_corpus", "synthetic"])
@pytest.mark.parametrize("width", WIDTHS)
def test_referential_sweeps_equal_at_every_width(corpus, width, join_refs):
    """Each plan's key table is K7 per shard and K7's merge: a key whose
    providers span shards counts each provider once at every width."""
    objs, want, totals, uncapped = join_refs[corpus]
    client = _load(TorchClient(driver=TorchDriver(device="cpu")), objs)
    client.driver.set_mesh(True, width=width)
    got = _sweep(client)
    assert got[0] == want and got[1] == totals
    assert got[4]["join_plans"] == 3.0 and got[4]["shards"] == float(width)
    single = _load(TorchClient(driver=TorchDriver(device="cpu")), objs)
    _same_sweep(got, _sweep(single))
    assert sig(client.audit().results()) == uncapped


# ---------------------------------------------------------------------------
# shard-boundary padding and the delta path (tests/test_mesh_sharding.py)
# ---------------------------------------------------------------------------


def _pair(n_templates, n_resources, width, seed=0):
    return (_port(n_templates, n_resources, width, seed),
            syn.build_oracle(n_templates, n_resources, seed))


def _with_oracle(pair, cap=CAP):
    """One port sweep and one oracle sweep over identical state: results
    and totals equal.  -> the port sweep's stats."""
    port, oracle = pair
    got_r, got_t = port.audit_capped(cap)
    stats = dict(port.driver.last_sweep_stats)
    want_r, want_t = oracle.audit_capped(cap)
    assert sig(got_r.results()) == sig(want_r.results())
    assert got_t == want_t
    return stats


def _churn_both(pair, start, n, tag="churned"):
    pods = syn.make_pods(start + n)[start:start + n]
    for p in pods:
        p["metadata"].setdefault("labels", {})[tag] = "yes"
        for client in pair:
            client.add_data(json.loads(json.dumps(p)))
    return pods


class TestShardBoundaryPadding:
    @pytest.mark.parametrize("width", [2, 3, 4, 8])
    def test_churn_row_lands_in_padded_tail(self, width):
        """New objects take rows in the padded tail (n_rows < capacity);
        the delta sweep gathers them on their owning shard, and the next
        full sweep patches them there."""
        pair = _pair(6, 9, width)  # capacity buckets to 16: tail rows 9..15
        driver = pair[0].driver
        driver.audit_capped(CAP)
        ap = driver._audit_pack
        assert ap.n_rows < ap.capacity
        _churn_both(pair, 9, 2, tag="tail")  # new rows 9, 10: the tail
        stats = _with_oracle(pair)
        assert ap.n_rows == 11 and ap.capacity == 16
        assert stats["delta_rows"] == 2.0
        assert stats["delta_shards"] == float(
            len(pm.owning_shards([9, 10], 16, width)))
        driver._delta_state = None
        driver._audit_cache = None
        full = _with_oracle(pair)
        assert full["scatter_rows"] == 2.0
        assert full["scatter_shards"] == stats["delta_shards"]
        assert sig(pair[0].audit().results()) == \
            sig(pair[1].audit().results())

    def test_tombstone_in_padded_region_stays_dead(self):
        """Deleting an object tombstones its row (valid=False); padded and
        tombstoned rows stay invisible to every shard, on the delta path
        and after a full sweep."""
        pair = _pair(6, 9, 4)
        driver = pair[0].driver
        driver.audit_capped(CAP)
        seg = next(p for p in driver._audit_pack.row_path if p is not None)
        for client in pair:
            client.driver.delete_data(seg)
        assert _with_oracle(pair)["delta_rows"] == 1.0
        driver._delta_state = None
        driver._audit_cache = None
        _with_oracle(pair)


class TestDeltaSweepUnderMesh:
    def test_churn_dispatches_only_dirty_rows(self):
        pair = _pair(8, 256, 4)
        driver = pair[0].driver
        driver.audit_capped(CAP)  # the full sweep rebases the delta basis
        _churn_both(pair, 10, 5)  # in-place churn of 5 existing objects
        st = _with_oracle(pair)
        assert st["delta_rows"] == 5.0
        assert st["shards"] == 4.0
        assert st["rows"] == 256.0  # the cluster, not re-dispatched
        assert st["delta_shards"] <= 2.0  # slab-local churn

    def test_churn_across_slabs_reports_owning_shards(self):
        client = _port(8, 256, 4)
        driver = client.driver
        driver.audit_capped(CAP)
        ap = driver._audit_pack
        # one live row in each 64-row slab, changed in place
        for r in (1, 65, 129, 193):
            obj = thaw(driver.store.get(ap.row_path[r]))
            obj["metadata"].setdefault("labels", {})["c"] = "y"
            client.add_data(obj)
        driver.audit_capped(CAP)
        st = driver.last_sweep_stats
        assert st["delta_rows"] == 4.0 and st["delta_shards"] == 4.0

    @pytest.mark.parametrize("width", [1, 3, 8])
    def test_delta_state_equals_tpu_driver(self, width):
        """After churn the port's incremental state at width W equals
        TpuDriver's on its 8-device mesh, and a forced full sweep gives
        the same counts."""
        port = _port(6, 120, width)
        tpu = jsyn.build_driver(6, 120)
        for c in (port, tpu):
            c.audit_capped(CAP)
        # 10 changed in place, 5 new in the tail of the 128-row bucket
        pods = syn.make_pods(125)[110:125]
        for p in pods:
            p["metadata"].setdefault("labels", {})["d"] = "x"
            for c in (port, tpu):
                c.add_data(json.loads(json.dumps(p)))
        (pr, pt), (jr, jt) = (c.audit_capped(CAP) for c in (port, tpu))
        assert sig(pr.results()) == sig(jr.results()) and pt == jt
        ps, js = port.driver._delta_state, tpu.driver._delta_state
        assert port.driver.last_sweep_stats["delta_rows"] == 15.0
        np.testing.assert_array_equal(ps.counts, js.counts)
        assert ps.cand == js.cand and ps.horizon == js.horizon
        counts = ps.counts.copy()
        port.driver._delta_state = None
        port.driver._audit_cache = None
        port.audit_capped(CAP)
        np.testing.assert_array_equal(port.driver._delta_state.counts,
                                      counts)

    def test_referential_churn_under_the_mesh(self, join_refs):
        """Key-moving churn on the join delta path at width 3: the
        affected readers re-evaluate against the host index's tables on
        the first device, K5 gathers on the owning shards."""
        objs = join_refs["synthetic"][0]
        port = _load(TorchClient(driver=TorchDriver(device="cpu")), objs)
        oracle = _load(JaxClient(driver=InterpDriver()), objs)
        port.driver.set_mesh(True, width=3)
        port.audit_capped(CAP)
        ing = next(o for o in objs[2] if o["kind"] == "Ingress")
        moved = copy.deepcopy(ing)
        moved["spec"]["rules"][0]["host"] = "moved.corp.io"
        for c in (port, oracle):
            c.add_data(copy.deepcopy(moved))
        st = _with_oracle((port, oracle))
        assert st["delta_rows"] >= 1.0 and "join_affected_rows" in st
        assert st["delta_shards"] >= 1.0
        assert sig(port.audit().results()) == \
            sig(oracle.audit().results())


# ---------------------------------------------------------------------------
# the topology API
# ---------------------------------------------------------------------------


class TestSetMeshApi:
    def test_width_change_invalidates_and_stays_correct(self):
        pair = _pair(6, 24, 2)
        driver = pair[0].driver
        r2 = _with_oracle(pair)
        assert r2["shards"] == 2.0
        driver.set_mesh(True, width=4)
        assert driver._audit_dev_mesh is None
        assert driver._delta_state is None
        assert driver._audit_cache is None
        assert _with_oracle(pair)["shards"] == 4.0

    def test_disable_returns_to_single_device(self):
        pair = _pair(6, 24, 4)
        _with_oracle(pair)
        pair[0].driver.set_mesh(False)
        assert pair[0].driver._mesh() is None
        assert _with_oracle(pair)["shards"] == 1.0

    def test_width_one_is_single_device(self):
        client = _port(4, 8, 1)
        assert client.driver._mesh() is None
        assert client.driver.mesh_layout() == 1

    def test_width_beyond_devices_rejected(self):
        client = _port(4, 8, 2)
        with pytest.raises(ValueError, match="exceeds visible devices"):
            client.driver.set_mesh(True, width=9)

    def test_gk_mesh_environment(self, monkeypatch):
        monkeypatch.setenv("GK_MESH", "4")
        assert TorchDriver(device="cpu").mesh_layout() == 4
        monkeypatch.setenv("GK_MESH", "0")
        assert TorchDriver(device="cpu")._mesh() is None
        monkeypatch.setenv("GK_MESH", "1")  # every visible device
        assert TorchDriver(device="cpu").mesh_layout() == 8
        for bad in ("9", "x", "-1"):
            monkeypatch.setenv("GK_MESH", bad)
            with pytest.raises(ValueError):
                TorchDriver(device="cpu")

    def test_delta_refuses_a_basis_of_another_width(self):
        """The mesh cache poked directly (not through set_mesh): the
        stamped basis no longer matches and the next sweep rebases."""
        pair = _pair(6, 24, 4)
        driver = pair[0].driver
        _with_oracle(pair)
        assert driver._delta_state.mesh_width == 4
        driver.mesh_width = 2
        driver._mesh_cache = None
        _churn_both(pair, 0, 2)
        st = _with_oracle(pair)
        assert "delta_rows" not in st and st["shards"] == 2.0
        assert driver._delta_state.mesh_width == 2


class TestDispatchWatchdog:
    def test_a_wedged_dispatch_stalls_and_the_mesh_degrades(self):
        client = _port(4, 16, 8)
        driver = client.driver
        driver.mesh_watchdog_s = 0.2
        release = threading.Event()
        try:
            with pytest.raises(pm.MeshDispatchStall):
                driver._guarded_mesh_dispatch(driver._mesh(),
                                              lambda: release.wait(10))
        finally:
            release.set()
        assert pm.DISPATCH_LOCK.revocations >= 1
        assert driver.mesh_layout() == 4  # the stall narrowed the mesh
        assert driver._guarded_mesh_dispatch(driver._mesh(), lambda: 7) == 7
        assert [driver.degrade_mesh() for _ in range(3)] == [2, 1, 1]
        assert driver._mesh() is None

    def test_a_stalled_review_degrades_the_mesh(self):
        """A review batch's shard evaluations run under the same guarded
        dispatch as the sweeps: the stall narrows the mesh and trips the
        breaker, and the numpy host tier answers the stalled batch."""
        client = _port(4, 16, 4)
        driver = client.driver
        driver.mesh_watchdog_s = 0.2
        release = threading.Event()

        def wedged(*_a, **_kw):
            release.wait(10)
            raise RuntimeError("the abandoned dispatch")

        oracle = jsyn.build_oracle(4, 16)
        pods = _review_pods(2)
        driver._eval = wedged
        try:
            stalled = client.review(copy.deepcopy(pods[0]))
        finally:
            release.set()
            del driver._eval
        assert driver.mesh_layout() == 2
        assert driver.breaker.state == "open"
        assert driver.route_ledger.last() == ("np", "device_failed")
        assert _review_sig([stalled]) == _review_sig([oracle.review(pods[0])])
        assert driver.breaker.probe_now()
        assert _review_sig([client.review(copy.deepcopy(pods[1]))]) == \
            _review_sig([oracle.review(pods[1])])
        assert driver.route_ledger.last()[0] == "device"

    def test_a_stalled_sweep_degrades_then_sweeps_narrower(self):
        pair = _pair(4, 16, 4)
        driver = pair[0].driver
        driver.mesh_watchdog_s = 0.2
        release = threading.Event()

        def wedged(*_a, **_kw):
            release.wait(10)  # abandoned: its result is never read
            raise RuntimeError("the abandoned dispatch")

        driver._sweep_shards = wedged
        try:
            got_r, got_t = pair[0].audit_capped(CAP)
        finally:
            release.set()
            del driver._sweep_shards
        # the interpreter answered the stalled sweep; the breaker is open
        want_r, want_t = pair[1].audit_capped(CAP)
        assert sig(got_r.results()) == sig(want_r.results())
        assert got_t == want_t
        assert driver.mesh_layout() == 2
        assert driver.breaker.state == "open"
        assert driver.breaker.probe_now()
        assert _with_oracle(pair)["shards"] == 2.0
