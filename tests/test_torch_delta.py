"""The port's incremental audit (gatekeeper_tpu_torch TorchDriver on the
CPU: the delta sweep, the resident row scatter, the sweep cache) against
the JAX TpuDriver and the InterpDriver oracle.

The seven scenarios of tests/test_delta_sweep.py run on three clients fed
the same make_templates / make_pods seeds.  After every sweep the port's
DeltaState counts, candidate lists, horizons and row columns equal
TpuDriver's exactly, and results equal the oracle's.  The [C, 2w] delta
columns are compared bit for bit with TpuDriver._delta_fn on identical
inputs carried by gatekeeper_tpu_torch/convert.py.  Tolerance 0 throughout:
every compared value is a bool, an int or a rendered string.

Numbers: the port compares numbers in float64 and TpuDriver in float32
(ROADMAP C1).  The synthetic corpus holds no number past 2^24, so the two
agree here bit for bit.
"""

import copy

import numpy as np
import pytest

from gatekeeper_tpu.client.client import Client as JaxClient
from gatekeeper_tpu.client.drivers import InterpDriver
from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu.util.synthetic import (
    audit_result_sig,
    make_pods,
    make_templates,
)
from gatekeeper_tpu_torch import convert
from gatekeeper_tpu_torch.client.client import Client as TorchClient
from gatekeeper_tpu_torch.ops.deltasweep import NeedsFullSweep
from gatekeeper_tpu_torch.ops.driver import TorchDriver


class Trio:
    """The port, TpuDriver and the oracle, each fed the same objects."""

    def __init__(self, n_templates=8, n_pods=150, violation_rate=0.3,
                 seed=21):
        tpu = TpuDriver()
        tpu.mesh_enabled = False
        tpu._mesh_cache = None
        self.t = TorchClient(driver=TorchDriver(device="cpu"))
        self.j = JaxClient(driver=tpu)
        self.o = JaxClient(driver=InterpDriver())
        templates, constraints = make_templates(n_templates)
        for t, k in zip(templates, constraints):
            self.each("add_template", t)
            self.each("add_constraint", k)
        for p in make_pods(n_pods, seed=seed, violation_rate=violation_rate):
            self.add(p)

    @property
    def clients(self):
        return self.t, self.j, self.o

    def each(self, method, obj):
        for c in self.clients:
            getattr(c, method)(copy.deepcopy(obj))

    def add(self, obj):
        self.each("add_data", obj)

    def remove(self, obj):
        self.each("remove_data", obj)

    def audit_capped(self, cap):
        """Capped sweeps on all three; the port's and TpuDriver's states
        must agree, and every exact total must equal the oracle's."""
        (rt, tt), (rj, tj), (_ro, to) = (c.audit_capped(cap)
                                         for c in self.clients)
        same_state(self.t.driver, self.j.driver)
        same_path(self.t.driver, self.j.driver)
        assert audit_result_sig(rt.results()) == \
            audit_result_sig(rj.results())
        assert tt == tj
        for k, (n, how) in tt.items():
            if how == "exact":
                assert n == to[k][0], (k, n, to[k])
        return rt, tt, to

    def audit_keys(self):
        """Uncapped audits: the port's results equal TpuDriver's and the
        oracle's, over the same path as TpuDriver's."""
        got = audit_result_sig(self.t.audit().results())
        assert got == audit_result_sig(self.j.audit().results())
        same_path(self.t.driver, self.j.driver)
        assert got == audit_result_sig(self.o.audit().results())
        return got


def same_state(td, jd):
    ts, js = td._delta_state, jd._delta_state
    assert (ts is None) == (js is None)
    if ts is None:
        return
    np.testing.assert_array_equal(ts.counts, js.counts)
    assert ts.cand == js.cand
    assert ts.horizon == js.horizon
    assert sorted(ts.row_cols) == sorted(js.row_cols)
    for r, col in ts.row_cols.items():
        np.testing.assert_array_equal(col, js.row_cols[r])
    np.testing.assert_array_equal(ts.crow, js.crow)
    assert ts.store_epoch == js.store_epoch


def same_path(td, jd):
    """Both drivers' last sweep took the same path over the same rows."""
    assert td.last_sweep_stats.get("delta_rows") == \
        jd.last_sweep_stats.get("delta_rows")
    assert td.last_sweep_stats.get("cached") == \
        jd.last_sweep_stats.get("cached")


def _named(seed, name, violation_rate=1.0):
    p = make_pods(1, seed=seed, violation_rate=violation_rate)[0]
    p["metadata"]["name"] = name
    return p


def test_delta_path_used_and_matches_oracle_over_many_mutations():
    trio = Trio()
    trio.audit_capped(5)  # cold full sweep bases the state
    pods = make_pods(150, seed=21, violation_rate=0.3)
    delta_sweeps = 0
    for i in range(6):
        # mix of add / modify / delete per sweep
        trio.add(_named(500 + i, f"delta-add-{i}"))
        mod = copy.deepcopy(pods[i])
        mod["metadata"]["labels"] = {} if i % 2 else {"owner": "x"}
        trio.add(mod)
        if i % 3 == 2:
            trio.remove(pods[10 + i])
        trio.audit_capped(5)
        delta_sweeps += "delta_rows" in trio.t.driver.last_sweep_stats
        trio.audit_keys()
        same_state(trio.t.driver, trio.j.driver)
    assert delta_sweeps >= 4, f"delta path unused ({delta_sweeps} sweeps)"


def test_delta_counts_match_full_recompute():
    trio = Trio(n_templates=6, n_pods=120)
    trio.audit_capped(4)
    for i in range(3):
        trio.add(_named(900 + i, f"probe-{i}"))
        trio.audit_capped(4)
    drv = trio.t.driver
    assert "delta_rows" in drv.last_sweep_stats
    delta_counts = drv._delta_state.counts.copy()
    # force a full resweep of the identical store and compare
    drv._delta_state = None
    drv._audit_cache = None
    trio.t.audit_capped(4)
    assert "delta_rows" not in drv.last_sweep_stats
    np.testing.assert_array_equal(delta_counts, drv._delta_state.counts)


def test_needs_full_sweep_escalation():
    """Exhausting the known horizon after deltas must transparently rebase
    with a full sweep, not miss candidates."""
    trio = Trio(n_templates=1, n_pods=500, violation_rate=0.9)
    cap = 30  # K = 64 < labelreq candidates (~0.9*0.4*500): finite horizon
    trio.audit_capped(cap)
    # make the state stale (delta applied), then chop its known candidates
    trio.add(_named(777, "stale-maker"))
    trio.audit_capped(cap)
    drv = trio.t.driver
    st = drv._delta_state
    assert st.row_cols, "the delta path must have run"
    target = next(i for i, h in enumerate(st.horizon) if h is not None)
    st.cand[target] = st.cand[target][:2]
    res, totals = trio.t.audit_capped(cap)
    _o_res, o_tot = trio.o.audit_capped(cap)
    for k, (n, how) in totals.items():
        if how == "exact":
            assert n == o_tot[k][0]
    assert drv._delta_state is not st, "state must have been rebased"
    assert not drv._delta_state.row_cols
    trio.audit_keys()


def test_stale_horizon_raises_needs_full_sweep():
    """The guard itself: after a delta the base mask is stale, so a
    constraint whose known candidates run out while it still has unknown
    ones raises NeedsFullSweep instead of reading the stale mask row."""
    trio = Trio(n_templates=1, n_pods=500, violation_rate=0.9)
    trio.audit_capped(30)
    trio.add(_named(778, "stale-guard"))
    trio.audit_capped(30)
    drv = trio.t.driver
    st = drv._delta_state
    target = next(i for i, h in enumerate(st.horizon) if h is not None)
    st.cand[target] = st.cand[target][:2]
    with pytest.raises(NeedsFullSweep):
        drv._render_capped(drv._audit_pack.reviews,
                           drv._ordered_constraints(), st, 30, None)
    # with no delta applied the same shortfall reads the fresh mask row
    drv._delta_state = None
    drv._audit_cache = None
    trio.t.audit_capped(30)
    st = drv._delta_state
    assert not st.row_cols
    target = next(i for i, h in enumerate(st.horizon) if h is not None)
    st.cand[target] = st.cand[target][:2]
    st.render_cache = {}
    drv._render_capped(drv._audit_pack.reviews, drv._ordered_constraints(),
                       st, 30, None)
    assert drv.last_sweep_stats["fallback_rows"] == 1.0
    assert st.horizon[target] is None


def test_many_dirty_rows_fall_back_to_full_sweep():
    trio = Trio(n_templates=4, n_pods=80)
    trio.audit_capped(5)
    for d in (trio.t.driver, trio.j.driver):
        d.DELTA_MAX_ROWS = 4
    for i in range(10):  # 10 dirty rows > 4
        trio.add(_named(1200 + i, f"bulk-{i}", violation_rate=0.5))
    trio.audit_capped(5)
    drv = trio.t.driver
    assert "delta_rows" not in drv.last_sweep_stats
    # and the state was rebased by the full sweep
    assert drv._delta_state.store_epoch == drv.store.epoch


def test_delta_disabled_env_forces_full_sweeps(monkeypatch):
    monkeypatch.setenv("GK_DELTA", "0")
    assert not TorchDriver(device="cpu").delta_enabled
    monkeypatch.delenv("GK_DELTA")
    trio = Trio(n_templates=4, n_pods=60)
    for d in (trio.t.driver, trio.j.driver):
        d.delta_enabled = False
    trio.audit_capped(5)
    trio.add(_named(1500, "nodelta"))
    trio.audit_capped(5)
    assert "delta_rows" not in trio.t.driver.last_sweep_stats
    assert trio.t.driver.last_sweep_stats["scatter_rows"] == 1.0
    trio.audit_keys()


def test_render_cache_respects_cap_changes():
    """Re-auditing an unchanged cluster with a different cap must re-render
    (the per-constraint render cache keys on the cap)."""
    trio = Trio(n_templates=4, n_pods=200, violation_rate=0.9)
    r5, _t5, _o5 = trio.audit_capped(5)
    r50, _t50, _o50 = trio.audit_capped(50)
    i50, _it50 = trio.o.audit_capped(50)

    def per(resp):
        out = {}
        for r in resp.results():
            k = r.constraint["metadata"]["name"]
            out[k] = out.get(k, 0) + 1
        return out

    assert per(r50) == per(i50)
    assert len(r50.results()) > len(r5.results())
    # shrinking the cap must bound results again
    r2, _t2, _o2 = trio.audit_capped(2)
    assert all(v <= 2 + 1 for v in per(r2).values()), per(r2)
    # an unchanged store is served from the state, not swept again
    assert trio.t.driver.last_sweep_stats.get("cached") == 1.0


def test_uncapped_audit_incremental_after_churn():
    """audit() must stay correct and incremental under churn: the base
    mask is fetched once, then changed columns are patched on the host."""
    trio = Trio(n_templates=6, n_pods=120)
    trio.audit_capped(5)  # base full sweep
    pods = make_pods(120, seed=21, violation_rate=0.3)
    for i in range(4):
        trio.add(_named(2500 + i, f"ua-{i}"))
        if i == 2:
            trio.remove(pods[7])
        trio.audit_keys()
        assert "delta_rows" in trio.t.driver.last_sweep_stats
        same_state(trio.t.driver, trio.j.driver)
    drv = trio.t.driver
    st = drv._delta_state
    assert st is not None and st.host_mask is not None
    # the host mask equals a fresh full fetch of the same store
    drv._delta_state = None
    drv._audit_cache = None
    _r, _o, fresh = drv._audit_masks()
    np.testing.assert_array_equal(st.host_mask, fresh)


def _churn(trio, seed):
    trio.add(_named(seed, f"carry-add-{seed}"))
    mod = copy.deepcopy(make_pods(150, seed=21, violation_rate=0.3)[3])
    mod["metadata"]["labels"] = {"owner": f"x{seed}"}
    trio.add(mod)


def _dirty_slices(driver):
    """Sync the pack and -> (rows_pad, rv_slice, cols_slice) for its
    delta-channel rows, padded as the delta path pads them."""
    side = driver._constraint_side()
    driver._audit_pack.sync(driver, side[3])
    rows = sorted(driver._audit_pack.delta_dirty)
    width = 8
    while width < len(rows):
        width *= 2
    rows_pad = np.asarray(rows + [rows[-1]] * (width - len(rows)), np.int32)
    ap = driver._audit_pack
    rv, cols = convert.take_rows((ap.rp, ap.cols), rows_pad)
    return rows_pad, rv, cols


def test_delta_columns_bit_equal_to_tpu_delta_fn():
    """The port's [C, 2w] (before | after) columns equal
    TpuDriver._delta_fn()'s on the same resident mask and the same dirty
    slices of the pack, carried over by convert.py."""
    trio = Trio()
    trio.audit_capped(5)
    for seed in (40, 41, 42):
        _churn(trio, seed)
    jd, td = trio.j.driver, trio.t.driver
    rows_pad, rv, cols = _dirty_slices(jd)
    t_rows_pad, _rv, _cols = _dirty_slices(td)
    np.testing.assert_array_equal(rows_pad, t_rows_pad)
    # the slices hold interned ids: both interners must hold the same
    # strings at the same ids
    assert jd.interner._strings == td.interner._strings
    _ordered, cp, groups, _specs, _crow = jd._constraint_side()
    cs_d, gp_d = jd._constraint_device_side(
        cp.arrays, [p for *_s, p in groups], None, None
    )
    mask_j = np.array(jd._delta_state.mask_src.get())  # writable copy
    want = np.asarray(
        jd._delta_fn()(mask_j, rows_pad, rv, cs_d, cols, gp_d)
    )
    side = td._constraint_side()
    got = td._delta_eval(
        side, td._constraint_device(side),
        convert.state_from_numpy(mask_j, td.device), rows_pad, rv, cols,
    ).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    assert want.shape[1] == 2 * len(rows_pad)
    np.testing.assert_array_equal(got, want)
    assert got[:, len(rows_pad):].any(), "the churned rows must flag"


def _referential_trio():
    """The port and TpuDriver on the referential corpus (unique hosts,
    required classes, team quotas), fed the same objects."""
    from gatekeeper_tpu.util import synthetic as jsyn

    tpu = TpuDriver()
    tpu.mesh_enabled = False
    tpu._mesh_cache = None
    t = TorchClient(driver=TorchDriver(device="cpu"))
    j = JaxClient(driver=tpu)
    templates, constraints = jsyn.make_referential_templates(6, 0)
    objs = jsyn.make_referential_objects(240, 1)
    for c in (t, j):
        for x in templates + constraints:
            getattr(c, "add_template" if x in templates else
                    "add_constraint")(copy.deepcopy(x))
        for o in objs:
            c.add_data(copy.deepcopy(o))
    return t, j


@pytest.fixture(scope="module", params=["synthetic", "referential"])
def swept_pair(request):
    """(port client, TpuDriver client, corpus) after a full capped sweep
    on each: the resident mask and, for the referential corpus, the join
    index current."""
    if request.param == "synthetic":
        trio = Trio()
        t, j = trio.t, trio.j
    else:
        t, j = _referential_trio()
    for c in (t, j):
        c.audit_capped(5)
    return t, j, request.param


@pytest.mark.parametrize("w", [8, 16, 256])
def test_program_eval_delta_bit_equal_to_tpu_delta_fn(swept_pair, w,
                                                      monkeypatch):
    """program_eval with ``delta`` (on the CPU: the plain groups, then
    delta_columns_plain into the output), as the port's delta sweep calls
    it, equals TpuDriver._delta_fn()'s [C, 2w] on the same resident mask
    and the same slices of the pack, at w = 8, 16 and 256 with the last
    quarter of the rows padding (the last row repeated, as both drivers
    pad); on the referential corpus with the host join index's tables."""
    from gatekeeper_tpu_torch.ops import driver as tdriver

    t, j, corpus = swept_pair
    td, jd = t.driver, j.driver
    assert jd.interner._strings == td.interner._strings
    ap = jd._audit_pack
    assert td._audit_pack.n_rows == ap.n_rows
    mask_j = np.array(jd._delta_state.mask_src.get())  # writable copy
    # rows the resident mask flags first, then the others, in a seeded
    # order
    rng = np.random.default_rng(w)
    flagged = mask_j[:, :ap.n_rows].any(0)
    order = np.concatenate([rng.permutation(np.flatnonzero(f))
                            for f in (flagged, ~flagged)])
    n = min(w - w // 4, ap.n_rows)
    rows = np.sort(order[:n])
    rows_pad = np.concatenate([rows, np.full(w - n, rows[-1])]).astype(
        np.int32)
    rv, cols = convert.take_rows((ap.rp, ap.cols), rows_pad)
    _ordered, cp, groups, _specs, _crow = jd._constraint_side()
    cs_d, gp_d = jd._constraint_device_side(
        cp.arrays, [p for *_s, p in groups], None, None
    )
    jt = jd._join_delta_tables()
    assert (jt is None) == (corpus == "synthetic")
    want = np.asarray(jd._delta_fn()(mask_j, rows_pad, rv, cs_d, cols, gp_d,
                                     *(() if jt is None else (jt,))))
    calls = []
    orig = tdriver.program_eval

    def spy(mask, groups, **kw):
        calls.append(kw)
        return orig(mask, groups, **kw)

    monkeypatch.setattr(tdriver, "program_eval", spy)
    side = td._constraint_side()
    got = td._delta_eval(
        side, td._constraint_device(side),
        convert.state_from_numpy(mask_j, td.device), rows_pad, rv, cols,
        td._join_delta_tables(),
    ).numpy()
    [kw] = calls
    assert set(kw) == {"delta"}
    assert got.dtype == np.int8 and got.shape == want.shape == \
        (mask_j.shape[0], 2 * w)
    np.testing.assert_array_equal(got, want)
    assert got[:, w:].any(), "the evaluated rows must flag"


def test_carried_state_folds_like_tpu_driver():
    """TpuDriver's DeltaState and resident mask, carried into the port by
    convert.delta_state_from: the port's next delta sweep folds the same
    churn into the same counts and candidates as TpuDriver's."""
    trio = Trio(n_templates=6, n_pods=120)
    trio.audit_capped(5)
    _churn(trio, 60)
    trio.audit_capped(5)  # both states now carry row columns
    jd, td = trio.j.driver, trio.t.driver
    jst = jd._delta_state
    assert jst.row_cols
    carried = convert.delta_state_from(
        jst, np.array(jst.mask_src.get()), td.device
    )
    assert (carried.cs_epoch, carried.layout_gen) == \
        (td._cs_epoch, td._audit_pack.layout_gen)
    td._delta_state = carried
    _churn(trio, 61)
    trio.audit_capped(5)
    assert td._delta_state is carried
    assert "delta_rows" in td.last_sweep_stats


def test_audit_device_inputs_patch_rows_without_a_full_upload():
    """A full sweep after churn re-sends only the dirty rows: the resident
    tensors are patched in place, upload_bytes is those rows' bytes, and
    the result equals a fresh upload of the whole pack."""
    client = TorchClient(driver=TorchDriver(device="cpu"))
    templates, constraints = make_templates(6)
    for t, k in zip(templates, constraints):
        client.add_template(t)
        client.add_constraint(k)
    for p in make_pods(100, seed=5, violation_rate=0.3):
        client.add_data(p)
    drv = client.driver
    drv.delta_enabled = False
    client.audit_capped(5)
    stats = drv.last_sweep_stats
    ap = drv._audit_pack
    full_bytes = convert.tree_nbytes((ap.rp, ap.cols))
    assert stats["upload_bytes"] == full_bytes
    layout, placed = drv._audit_dev
    for i in range(3):
        client.add_data(_named(3000 + i, f"patched-{i}"))
    client.audit_capped(5)
    stats = drv.last_sweep_stats
    assert stats["scatter_rows"] == 3.0
    row_bytes = full_bytes // ap.capacity
    assert stats["upload_bytes"] == 3 * row_bytes < full_bytes
    assert drv._audit_dev[0] == layout and drv._audit_dev[1] is placed
    fresh = convert.state_from_numpy((ap.rp, ap.cols), drv.device)
    rv, cols = placed
    for k, t in fresh[0].items():
        assert rv[k].equal(t), k
    for ck, leaves in fresh[1].items():
        for leaf, t in leaves.items():
            assert cols[ck][leaf].equal(t), (ck, leaf)


def test_reset_drops_the_incremental_state():
    client = TorchClient(driver=TorchDriver(device="cpu"))
    templates, constraints = make_templates(2)
    for t, k in zip(templates, constraints):
        client.add_template(t)
        client.add_constraint(k)
    for p in make_pods(20, seed=9, violation_rate=0.5):
        client.add_data(p)
    client.audit_capped(5)
    drv = client.driver
    assert drv._delta_state is not None and drv._audit_cache is not None
    drv.reset()
    assert drv._delta_state is None and drv._audit_cache is None
    assert drv._audit_dev is None


def test_join_plans_keep_every_sweep_full():
    """With join plans installed, a churn sweep takes the delta path (the
    churned row and the readers of its key groups), and the full sweep
    forced after it patches the row into the resident inputs; both equal
    the oracle's results."""
    from gatekeeper_tpu_torch.util import synthetic as tsyn

    client = tsyn.build_referential_driver(3, 60, device="cpu")
    oracle = tsyn.build_referential_oracle(3, 60)
    drv = client.driver
    assert any(getattr(p, "join_plans", ()) for p in drv.programs.values())
    client.audit_capped(5)
    assert drv._delta_state is not None
    obj = copy.deepcopy(tsyn.make_referential_objects(60, 1)[0])
    obj["metadata"]["name"] = "join-churn"
    for c in (client, oracle):
        c.add_data(copy.deepcopy(obj))
    client.audit_capped(5)
    assert drv.last_sweep_stats["delta_rows"] == 1.0
    assert drv.last_sweep_stats["join_affected_rows"] == 0.0
    want = audit_result_sig(oracle.audit().results())
    assert audit_result_sig(client.audit().results()) == want
    drv._delta_state = None
    drv._audit_cache = None
    client.audit_capped(5)
    assert "delta_rows" not in drv.last_sweep_stats
    assert drv.last_sweep_stats["scatter_rows"] >= 1.0
    assert audit_result_sig(client.audit().results()) == want


def test_failed_delta_sweep_rebases_through_a_full_sweep(monkeypatch):
    """As in TpuDriver._try_delta: a delta sweep that raises is logged, its
    state dropped, and the same call is served by a full sweep on the
    device, whose results equal the oracle's."""
    client = TorchClient(driver=TorchDriver(device="cpu"))
    oracle = JaxClient(driver=InterpDriver())
    templates, constraints = make_templates(4)
    for c in (client, oracle):
        for t, k in zip(templates, constraints):
            c.add_template(copy.deepcopy(t))
            c.add_constraint(copy.deepcopy(k))
        for p in make_pods(60, seed=13, violation_rate=0.5):
            c.add_data(p)
    drv = client.driver
    client.audit_capped(5)
    for c in (client, oracle):
        c.add_data(_named(4000, "fails-delta"))

    def boom(*_a, **_kw):
        raise RuntimeError("delta gather failed")

    monkeypatch.setattr(drv, "_delta_eval", boom)
    resp, totals = client.audit_capped(5)
    stats = drv.last_sweep_stats
    assert "delta_rows" not in stats and stats["scatter_rows"] == 1.0
    assert drv._delta_state is not None and not drv._audit_pack.delta_dirty
    _o_resp, o_totals = oracle.audit_capped(5)
    for k, (n, how) in totals.items():
        if how == "exact":
            assert n == o_totals[k][0], (k, n, o_totals[k])
    assert audit_result_sig(client.audit().results()) == \
        audit_result_sig(oracle.audit().results())
