"""TorchDriver's telemetry against TpuDriver's, on the CPU.

The same seeded corpora (synthetic 18 x 300, referential 12 x 300) and the
same operations go through TpuDriver on the CPU JAX backend (its device
path forced for reviews) and TorchDriver(device="cpu"): a full capped
sweep, churn with a delta sweep, a review batch, a mesh of 3 slots
(GK_VIRTUAL_DEVICES=3 for the port, 3 of the conftest's 8 CPU devices for
TpuDriver) and a stalled mesh dispatch that degrades it.  Inside one root
span each side must give:

- the same span names with the same attributes, timings dropped and the
  device tier's name ("tpu" in the JAX package, "torch" in the port)
  read as one;
- the same metric series and counts (render_cells_total by plan,
  join_plans, join_delta_affected_rows_total, audit_shard_rows,
  mesh_sweep_width, mesh_dispatch_stalls_total, tpu_pack_seconds and
  tpu_dispatch_seconds by path and tier), read from a registry of its
  own for the test;
- the same flight-recorder event kinds;
- the same per-template and per-constraint cost-ledger cells, tier mix,
  memo hits and violations.

With every hook on, the port's results stay byte-equal to TpuDriver's
and to the InterpDriver oracle's (capped results a subset of the
oracle's, as the cap allows).  Tolerance 0: every compared value is a
count, a name or a rendered string.
"""

import copy
import importlib
import json
import time

import pytest

from gatekeeper_tpu.util import synthetic as jsyn
from gatekeeper_tpu_torch.parallel import mesh as pm
from gatekeeper_tpu_torch.util import synthetic as syn

CAP = 20
SYNTHETIC = (18, 300)
REFERENTIAL = (12, 300)
MESH_WIDTH = 3
sig = syn.audit_result_sig

COUNTERS = ("render_cells_total", "join_delta_affected_rows_total",
            "mesh_dispatch_stalls_total")
HISTOGRAMS = ("audit_shard_rows", "audit_shard_pack_seconds",
              "audit_shard_dispatch_seconds", "tpu_pack_seconds",
              "tpu_dispatch_seconds")
GAUGES = ("join_plans", "mesh_sweep_width")
# the span attributes that are times
TIMINGS = ("start", "duration_ms")


class Side:
    """One package's modules, a client and its oracle over one corpus."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.views = mod("metrics.views")
        self.catalog = mod("metrics.catalog")
        self.trace = mod("obs.trace")
        self.costs = mod("obs.costs")
        self.flightrec = mod("obs.flightrec")
        self.faults = mod("faults")
        self.client = None
        self.oracle = None

    @property
    def driver(self):
        return self.client.driver


def _build(corpus):
    """(JAX side, port side) over ``corpus``, each with its oracle, every
    driver on one device."""
    jax, port = Side("gatekeeper_tpu"), Side("gatekeeper_tpu_torch")
    n, r = SYNTHETIC if corpus == "synthetic" else REFERENTIAL
    if corpus == "synthetic":
        jax.client = jsyn.build_driver(n, r)
        jax.oracle = jsyn.build_oracle(n, r)
        port.client = syn.build_driver(n, r, device="cpu")
        port.oracle = jsyn.build_oracle(n, r)
    else:
        jax.client = jsyn.build_referential_driver(n, r)
        jax.oracle = jsyn.build_referential_oracle(n, r)
        port.client = syn.build_referential_driver(n, r, device="cpu")
        port.oracle = jsyn.build_referential_oracle(n, r)
    # both drivers' reviews on their device paths: no host tier, no prior
    for side in (jax, port):
        side.driver.DEVICE_MIN_CELLS = 0
        side.driver.np_serve_enabled = False
        side.driver.set_mesh(False)
    return jax, port


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Three virtual slots for the port's mesh, and for each package a
    metrics registry, a cost ledger and a flight recorder of the test's
    own."""
    monkeypatch.setenv(pm.VIRTUAL_DEVICES_ENV, str(MESH_WIDTH))
    monkeypatch.delenv("GK_MESH", raising=False)
    for pkg in ("gatekeeper_tpu", "gatekeeper_tpu_torch"):
        views = importlib.import_module(f"{pkg}.metrics.views")
        catalog = importlib.import_module(f"{pkg}.metrics.catalog")
        monkeypatch.setattr(views, "_global", views.Registry())
        monkeypatch.setattr(catalog, "_GLOBAL_READY", False)
        costs = importlib.import_module(f"{pkg}.obs.costs")
        costs.get_ledger().clear()
        monkeypatch.setattr(costs.get_ledger(), "enabled", True)
        importlib.import_module(f"{pkg}.obs.flightrec").get_recorder().clear()
    yield
    for pkg in ("gatekeeper_tpu", "gatekeeper_tpu_torch"):
        importlib.import_module(f"{pkg}.obs.costs").get_ledger().clear()
        importlib.import_module(f"{pkg}.obs.flightrec").get_recorder().clear()


def _metrics(side) -> dict:
    reg = side.catalog._global()
    out = {}
    for name in COUNTERS:
        for key, v in reg.view_rows(name).items():
            out[(name, key)] = v
    for name in HISTOGRAMS:
        for key, v in reg.view_rows(name).items():
            # the device tier's tag: "tpu" in the JAX package
            key = tuple("torch" if t == "tpu" else t for t in key)
            out[(name, key)] = v.count
    for name in GAUGES:
        for key, v in reg.view_rows(name).items():
            out[(name, key, "value")] = v
    return out


def _normalize(attrs: dict) -> dict:
    out = {k: v for k, v in (attrs or {}).items() if k not in TIMINGS}
    if out.get("tier") == "tpu":
        out["tier"] = "torch"
    return out


def _costs(side) -> dict:
    """Per template and per constraint: cells, render cells, tier mix,
    memo hits, violations (the ledger's times dropped)."""
    ledger = side.costs.get_ledger()
    keep = ("cells", "render_cells", "tier_mix", "memo_hits", "violations")
    out = {t: {k: row[k] for k in keep}
           for t, row in ledger.totals_by_template().items()}
    for t in ledger.snapshot(top=10_000)["templates"]:
        for c in t.get("constraints", ()):
            out[(t["template"], c["constraint"])] = {k: c[k] for k in keep}
    return out


def _observe(side, op):
    """Run ``op(side)`` inside a root span -> (its return, the telemetry
    it made: spans, metric deltas, flight-recorder kinds, cost ledger)."""
    before = _metrics(side)
    side.flightrec.get_recorder().clear()
    side.costs.get_ledger().clear()
    with side.trace.root_span("telemetry-test") as root:
        got = op(side)
    spans = sorted(
        json.dumps([rec["name"], _normalize(rec.get("attrs"))],
                   sort_keys=True, default=str)
        for rec in root.trace.spans if rec["name"] != "telemetry-test")
    after = _metrics(side)
    metrics = {}
    for key, v in after.items():
        if key[-1] == "value":
            metrics[key] = v  # a gauge: its value now
        elif v != before.get(key, 0):
            metrics[key] = v - before.get(key, 0)
    kinds = sorted(e["type"] for e in
                   side.flightrec.get_recorder().events())
    return got, {"spans": spans, "metrics": metrics, "events": kinds,
                 "costs": _costs(side)}


def _review_pods(n, seed, tag):
    pods = syn.make_pods(n, seed=seed, violation_rate=0.5)
    out = []
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"{tag}-{i}"
        out.append({
            "uid": f"{tag}-{i}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": p["metadata"]["name"],
            "namespace": p["metadata"]["namespace"],
            "operation": "CREATE", "object": p,
        })
    return out


def _review_sig(responses):
    return [[(r.constraint["kind"], r.constraint["metadata"]["name"],
              r.msg, r.enforcement_action) for r in resp.results()]
            for resp in responses]


def _sweep(side):
    resp, totals = side.client.audit_capped(CAP)
    return sig(resp.results()), totals


def _churn(side, corpus):
    """Change objects in both the client and its oracle: pods relabelled
    and added (synthetic), or an Ingress's host moved (referential, a
    key-moving change whose key group's readers re-evaluate)."""
    if corpus == "synthetic":
        objs = syn.make_pods(SYNTHETIC[1] + 4, seed=1)[-10:]
        for o in objs[:6]:
            o["metadata"].setdefault("labels", {})["churn"] = "x"
        changed = objs
    else:
        objs = syn.make_referential_objects(REFERENTIAL[1], seed=1)
        ing = copy.deepcopy([o for o in objs if o["kind"] == "Ingress"][:3])
        # the first onto the second's host (its group gains a reader),
        # the third onto a host no object has
        ing[0]["spec"]["rules"][0]["host"] = \
            ing[1]["spec"]["rules"][0]["host"]
        ing[2]["spec"]["rules"][0]["host"] = "moved.corp.io"
        changed = [ing[0], ing[2]]
    for obj in changed:
        for c in (side.client, side.oracle):
            c.add_data(copy.deepcopy(obj))


def _force_full(driver):
    driver._delta_state = None
    driver._audit_cache = None


def _check_sweep(side, got):
    results, totals = got
    oracle_all = set(sig(side.oracle.audit().results()))
    assert results and set(results) <= oracle_all
    _o, o_tot = side.oracle.audit_capped(CAP)
    for key, (n, how) in totals.items():
        if how == "exact":
            assert n == o_tot[key][0], key


# ---- the operations ---------------------------------------------------------


def op_full_sweep(side, corpus):
    got = _sweep(side)
    _check_sweep(side, got)
    return got


def op_delta_sweep(side, corpus):
    side.client.audit_capped(CAP)  # the basis
    _churn(side, corpus)
    got = _sweep(side)
    stats = side.driver.last_sweep_stats
    assert "delta_rows" in stats, stats
    if corpus == "referential":
        assert stats["join_affected_rows"] > 0, stats
    _check_sweep(side, got)
    return got


def op_review_batch(side, corpus):
    reqs = _review_pods(8, seed=41, tag="tele")
    got = _review_sig(side.client.review_batch(copy.deepcopy(reqs)))
    assert got == _review_sig(side.oracle.review_batch(
        copy.deepcopy(reqs)))
    return got


def op_np_review(side, corpus):
    """The review batch of op_review_batch served by the numpy host tier:
    the device's prior raised past the batch, the numpy tier's to 0."""
    side.driver.DEVICE_MIN_CELLS = 10**9
    side.driver.NP_MIN_CELLS = 0
    side.driver.np_serve_enabled = True
    got = op_review_batch(side, corpus)
    assert side.driver.route_ledger.last() == ("np", "uncalibrated_prior")
    return got


def op_mesh(side, corpus):
    side.driver.set_mesh(True, width=MESH_WIDTH)
    got = [_sweep(side)]
    assert side.driver.last_sweep_stats["shards"] == MESH_WIDTH
    _check_sweep(side, got[0])
    if corpus == "synthetic":
        reqs = _review_pods(5, seed=43, tag="mesh")
        got.append(_review_sig(side.client.review_batch(
            copy.deepcopy(reqs))))
        assert got[-1] == _review_sig(side.oracle.review_batch(
            copy.deepcopy(reqs)))
    return got


def op_degrade(side, corpus):
    """A sweep whose mesh dispatch hangs past the watchdog: the breaker
    opens, the mesh narrows from 3 to 1 and the interpreter answers;
    then the probe closes the breaker and a sweep at the new width
    equals the oracle's."""
    driver = side.driver
    plane = side.faults.install(seed=1234)
    try:
        plane.add(side.faults.MESH_DISPATCH_STALL,
                  side.faults.FaultRule(mode="hang", hang_s=10.0, count=1))
        _force_full(driver)
        stalled = _sweep(side)
        assert driver.mesh_layout() == 1
        assert driver.breaker.state == "open", driver.breaker.status()
        plane.release_hangs()
        time.sleep(0.3)  # the abandoned dispatch finishes alone
        plane.clear(side.faults.MESH_DISPATCH_STALL)
    finally:
        side.faults.uninstall()
    assert driver.breaker.probe_now(), driver.breaker.status()
    _force_full(driver)
    after = _sweep(side)
    assert driver.last_sweep_stats["shards"] == 1
    _check_sweep(side, after)
    return [stalled, after]


OPS = {
    "full_sweep": op_full_sweep,
    "delta_sweep": op_delta_sweep,
    "review_batch": op_review_batch,
    "np_review": op_np_review,
    "mesh": op_mesh,
    "degrade": op_degrade,
}
CASES = [(op, corpus) for op in OPS
         for corpus in ("synthetic", "referential")
         if not (op in ("review_batch", "np_review")
                 and corpus == "referential")]


def _prepare(op, jax, port):
    """What an operation needs before it is observed: a warm mesh of
    MESH_WIDTH with the watchdog armed for the degrade (its first,
    compiling dispatch made without it)."""
    if op != "degrade":
        return
    for side in (jax, port):
        side.driver.set_mesh(True, width=MESH_WIDTH)
        side.client.audit_capped(CAP)
        side.driver.mesh_watchdog_s = 0.5


@pytest.mark.parametrize("op,corpus", CASES)
def test_the_ports_telemetry_equals_the_jax_packages(op, corpus):
    jax, port = _build(corpus)
    _prepare(op, jax, port)
    got_j, tele_j = _observe(jax, lambda s: OPS[op](s, corpus))
    got_p, tele_p = _observe(port, lambda s: OPS[op](s, corpus))
    assert got_p == got_j
    assert tele_p["spans"] == tele_j["spans"]
    assert tele_p["metrics"] == tele_j["metrics"]
    assert tele_p["events"] == tele_j["events"]
    assert tele_p["costs"] == tele_j["costs"]
    # the operation fed the series it exists for
    assert tele_p["spans"] and tele_p["costs"]
    names = {json.loads(s)[0] for s in tele_p["spans"]}
    series = {k[0] for k in tele_p["metrics"]}
    if op in ("full_sweep", "mesh", "degrade"):
        assert {"audit.pack", "audit.dispatch", "audit.fetch",
                "audit.render"} <= names
    if op == "delta_sweep":
        assert "audit.render" in names
        if corpus == "referential":
            assert "join_delta_affected_rows_total" in series
    if op == "review_batch":
        assert {"tpu.pack", "tpu.dispatch", "render",
                "render.plan"} <= names
    if op == "np_review":
        assert {"np.pack", "np.eval", "render"} <= names
        assert tele_p["metrics"][("tpu_dispatch_seconds",
                                  ("review", "numpy"))] == 1
    if op == "mesh":
        assert {"audit.shard_pack", "audit.shard_dispatch"} <= names
        assert tele_p["metrics"][("mesh_sweep_width", (),
                                  "value")] == MESH_WIDTH
        assert "audit_shard_rows" in series
    if op == "degrade":
        assert tele_p["metrics"][("mesh_dispatch_stalls_total", ())] == 1
        assert tele_p["metrics"][("mesh_sweep_width", (), "value")] == 1
        assert "mesh_degrade" in tele_p["events"]
    if corpus == "referential" and op != "review_batch":
        assert tele_p["metrics"][("join_plans", (), "value")] == 3
    if op in ("full_sweep", "mesh"):
        assert "render_cells_total" in series


@pytest.mark.parametrize("pipelined", [False, True])
def test_the_slab_commit_records_each_shard_on_the_calling_thread(
        monkeypatch, pipelined):
    """pipelined_shard_commit's record_shard hook, as the JAX package's
    pipelined_shard_commit calls it: once a shard committed, in shard
    order, on the caller's thread (the packer thread's pack times carried
    over), with the slab's rows; with PIPELINE_MIN_SLAB_ROWS lowered the
    packer thread runs."""
    import threading

    import numpy as np

    if pipelined:
        monkeypatch.setattr(pm, "PIPELINE_MIN_SLAB_ROWS", 0)
    rows = 10
    rv = {"valid": np.ones(rows, bool),
          "ids": np.arange(rows * 2, dtype=np.int32).reshape(rows, 2)}
    cols = {("c",): {"sid": np.arange(rows, dtype=np.int32)}}
    seen = []

    def record(shard, n, pt0, pt1, ct0, ct1):
        seen.append((shard, n, threading.get_ident()))
        assert pt0 <= pt1 and ct0 <= ct1

    mesh = pm.audit_mesh(MESH_WIDTH, "cpu")
    _shards, target = pm.shard_review_side(mesh, rows, rv, cols,
                                           record_shard=record)
    slab = target // MESH_WIDTH
    me = threading.get_ident()
    assert seen == [(s, slab, me) for s in range(MESH_WIDTH)]
