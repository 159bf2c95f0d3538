"""Cap-aware audit: cap-bounded host render vs the exact interpreter path.

The status write-back keeps at most --constraint-violations-limit violations
per constraint (reference pkg/audit/manager.go:49), so the device driver walks
the device candidate mask per constraint in row order and stops rendering at
the cap, with device-counted "resources" totals for capped constraints.

The port's copy of tests/test_audit_capped.py: the same scenarios on
gatekeeper_tpu_torch, with TorchDriver on the CPU where the JAX test
builds TpuDriver, and the mesh scenario on GK_VIRTUAL_DEVICES slots."""


from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.client.drivers import InterpDriver
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.util.synthetic import make_pods, make_templates


def _loaded(driver, n_templates=6, n_pods=60, violation_rate=0.5):
    templates, constraints = make_templates(n_templates)
    c = Client(driver=driver)
    for t in templates:
        c.add_template(t)
    for cons in constraints:
        c.add_constraint(cons)
    for p in make_pods(n_pods, seed=7, violation_rate=violation_rate):
        c.add_data(p)
    return c


def _result_keys(results):
    return sorted(
        (r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
         str(r.review.get("object", {}).get("metadata", {}).get("name")))
        for r in results
    )


def test_capped_matches_exact_when_under_cap():
    """cap larger than any per-constraint violation count: capped results
    and totals must equal the exact audit on both drivers."""
    ct = _loaded(TorchDriver(device="cpu"))
    ci = _loaded(InterpDriver())
    exact = ci.audit().results()
    res_t, totals_t = ct.audit_capped(10_000)
    res_i, totals_i = ci.audit_capped(10_000)
    assert _result_keys(res_t.results()) == _result_keys(exact)
    assert _result_keys(res_i.results()) == _result_keys(exact)
    assert totals_t == totals_i
    assert all(how == "exact" for _n, how in totals_t.values())
    # totals agree with a direct per-constraint count of the exact audit
    per = {}
    for r in exact:
        kk = (r.constraint["kind"], r.constraint["metadata"]["name"])
        per[kk] = per.get(kk, 0) + 1
    for kk, (n, _how) in totals_t.items():
        assert per.get(kk, 0) == n


def test_cap_bounds_results_per_constraint():
    cap = 3
    ct = _loaded(TorchDriver(device="cpu"))
    res, totals = ct.audit_capped(cap)
    per = {}
    for r in res.results():
        kk = (r.constraint["kind"], r.constraint["metadata"]["name"])
        per[kk] = per.get(kk, 0) + 1
    assert per, "workload must produce violations"
    # a single cell can render several violations, so the bound is
    # cap + (max violations per cell - 1); for this corpus a cell yields
    # at most 2 (two missing labels)
    assert all(n <= cap + 1 for n in per.values()), per
    # capped constraints report "resources" totals >= the kept results
    interp = _loaded(InterpDriver())
    exact_per = {}
    for r in interp.audit().results():
        kk = (r.constraint["kind"], r.constraint["metadata"]["name"])
        exact_per[kk] = exact_per.get(kk, 0) + 1
    for kk, (n, how) in totals.items():
        if how == "exact":
            assert exact_per.get(kk, 0) == n, kk
        else:
            assert n >= per.get(kk, 0)


def test_capped_results_are_subset_of_exact():
    cap = 2
    ct = _loaded(TorchDriver(device="cpu"))
    interp = _loaded(InterpDriver())
    capped_keys = set(_result_keys(ct.audit_capped(cap)[0].results()))
    exact_keys = set(_result_keys(interp.audit().results()))
    assert capped_keys <= exact_keys


def test_capped_on_mesh_matches_single_device(monkeypatch):
    from gatekeeper_tpu_torch.parallel import mesh as pm

    monkeypatch.setenv(pm.VIRTUAL_DEVICES_ENV, "8")
    ct = _loaded(TorchDriver(device="cpu"))
    ct.driver.set_mesh(True)
    assert ct.driver._mesh() is not None
    res_mesh, totals_mesh = ct.audit_capped(4)

    ct2 = _loaded(TorchDriver(device="cpu"))
    ct2.driver.mesh_enabled = False
    res_single, totals_single = ct2.audit_capped(4)
    assert totals_mesh == totals_single
    assert _result_keys(res_mesh.results()) == _result_keys(res_single.results())


def test_capped_resources_totals_match_device_counts():
    """With a cap far below the violating-cell count, capped constraints
    must report "resources" totals equal to the device mask's per-constraint
    cell counts.  Use a high violation rate so every constraint caps."""
    ct = _loaded(TorchDriver(device="cpu"), n_templates=3, n_pods=120, violation_rate=0.9)
    interp = _loaded(InterpDriver(), n_templates=3, n_pods=120, violation_rate=0.9)
    res, totals = ct.audit_capped(2)
    per = {}
    for r in res.results():
        kk = (r.constraint["kind"], r.constraint["metadata"]["name"])
        per[kk] = per.get(kk, 0) + 1
    exact_cells = {}
    _o, mask, _a = ct.driver.compute_masks(
        [ct.driver.target.make_audit_review(o, a, k, n, ns)
         for o, a, k, n, ns in (
             (__import__("gatekeeper_tpu_torch.engine.value", fromlist=["thaw"]).thaw(of), api, kn, nm, ns)
             for of, api, kn, nm, ns in ct.driver.store.iter_objects())]
    )
    for ci, (kind, name, _c) in enumerate(_o):
        exact_cells[(kind, name)] = int(mask[ci].sum())
    for kk, (n, how) in totals.items():
        if how == "resources":
            assert n == exact_cells[kk], (kk, n, exact_cells[kk])


def test_manager_totals_key_matches_status_key_with_namespace():
    """A constraint carrying metadata.namespace must have its driver-exact
    total land under the same status key _add_results uses, not a
    cluster-scoped 'Kind//name' variant."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager
    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube

    kube = InMemoryKube()
    templates, constraints = make_templates(2)
    driver = TorchDriver(device="cpu")
    c = Client(driver=driver)
    for t in templates:
        c.add_template(t)
    for cons in constraints:
        cons = dict(cons)
        cons["metadata"] = dict(cons["metadata"], namespace="weird-ns")
        c.add_constraint(cons)
        kube.create(dict(cons))
    for p in make_pods(30, seed=3, violation_rate=0.9):
        c.add_data(p)
    mgr = AuditManager(kube=kube, client=c, from_cache=True,
                       violations_limit=2, interval_s=1e9)
    mgr.audit_once()
    wrote = 0
    for gvk in mgr._constraint_kinds():
        for obj in kube.list(gvk):
            status = obj.get("status") or {}
            if "totalViolations" in status:
                wrote += 1
                assert status["totalViolations"] >= len(
                    status.get("violations") or [])
    assert wrote, "namespaced constraints must still receive status totals"


def test_manager_action_totals_counted_when_nothing_rendered():
    """violations_limit=0 keeps no results; per-action totals must still
    reflect the driver-exact counts."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager
    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube

    kube = InMemoryKube()
    ct = _loaded(TorchDriver(device="cpu"), n_templates=3, n_pods=30, violation_rate=0.9)
    _templates, constraints = make_templates(3)
    for cons in constraints:
        kube.create(dict(cons))

    seen = {}

    class Reporter:
        def report_audit_last_run(self, *a):
            pass

        def report_audit_duration(self, *a):
            pass

        def report_total_violations(self, action, n):
            seen[action] = n

    mgr = AuditManager(kube=kube, client=ct, from_cache=True,
                       violations_limit=0, interval_s=1e9,
                       reporter=Reporter())
    mgr.audit_once()
    assert sum(seen.values()) > 0, seen


def test_capped_empty_inventory_totals_contract():
    """Both drivers report (0, 'exact') for every registered constraint on
    an empty inventory."""
    templates, constraints = make_templates(3)
    for drv in (TorchDriver(device="cpu"), InterpDriver()):
        c = Client(driver=drv)
        for t in templates:
            c.add_template(t)
        for cons in constraints:
            c.add_constraint(cons)
        res, totals = c.audit_capped(5)
        assert res.results() == []
        assert len(totals) == len(constraints)
        assert all(v == (0, "exact") for v in totals.values())


def test_audit_manager_uses_capped_totals():
    """From-cache audit manager writes capped violation lists but
    driver-exact totals."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager
    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube

    kube = InMemoryKube()
    ct = _loaded(TorchDriver(device="cpu"), n_templates=4, n_pods=40, violation_rate=0.8)
    # register the constraints in the kube store so status writes land
    templates, constraints = make_templates(4)
    for cons in constraints:
        cons = dict(cons)
        kube.create(dict(cons))
    mgr = AuditManager(
        kube=kube, client=ct, from_cache=True, violations_limit=3,
        interval_s=1e9,
    )
    update_lists = mgr.audit_once()
    assert update_lists
    for key, viols in update_lists.items():
        assert len(viols) <= 3
    # status got totals >= listed violations
    for gvk in mgr._constraint_kinds():
        for c in kube.list(gvk):
            status = c.get("status") or {}
            if "violations" in status:
                assert status["totalViolations"] >= len(status["violations"])


def test_status_carries_totals_exact_marker():
    """The constraint status surfaces whether
    totalViolations is exact (violation semantics) or a device-candidate
    approximation past the cap."""
    from gatekeeper_tpu_torch.audit.manager import AuditManager
    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube

    kube = InMemoryKube()
    ct = _loaded(TorchDriver(device="cpu"), n_templates=6, n_pods=60, violation_rate=0.8)
    templates, constraints = make_templates(6)
    for cons in constraints:
        kube.create(dict(cons))
    mgr = AuditManager(
        kube=kube, client=ct, from_cache=True, violations_limit=2,
        interval_s=1e9,
    )
    mgr.audit_once()
    markers = {}
    for gvk in mgr._constraint_kinds():
        for c in kube.list(gvk):
            status = c.get("status") or {}
            assert "totalViolationsExact" in status
            markers[c["metadata"]["name"]] = status["totalViolationsExact"]
    # the synthetic corpus has both count-exact (labelreq) and inexact
    # (privflag et al) families over the cap
    _res, totals = ct.audit_capped(2)
    want = {f"c-{k[0].lower()}": how == "exact"
            for k, (n, how) in totals.items()}
    for name, exact in markers.items():
        assert exact == want[name], (name, exact)
