#!/usr/bin/env python
"""Static observability conformance check of gatekeeper_tpu_torch (wired
as a tier-1 test via tests/test_torch_observability_tool.py; also
runnable standalone).  The port's metrics catalog, obs/, fleet/ and
webhook/ are copies of the JAX package's, so the checks are its twin's
over the port's modules, against the same docs/*.md (reading a doc is no
import):

1. Every Measure defined in gatekeeper_tpu_torch/metrics/catalog.py is bound to
   at least one View in catalog_views() — an unbound measure records into
   the void and its call sites silently export nothing.
2. Every exported metric name (view name) appears in docs/metrics.md —
   the doc is the operator contract; an undocumented metric is either
   missing docs or a leftover.
3. No hot-path module times spans with the wall clock: ``time.time()`` is
   forbidden in the listed modules unless the line carries a
   ``wall-clock: ok`` annotation (legitimate uses are epoch timestamps
   for export, never durations — wall time steps under NTP and would
   corrupt span/stage math).
4. Exemplar well-formedness: a registry with trace-linked
   distribution samples must render OpenMetrics that terminates with
   ``# EOF``, attaches exemplars as ``# {trace_id="<32 hex>"} value ts``
   on bucket lines, and keeps exemplars OUT of the classic text format.
5. Label-cardinality lint: any catalog view carrying a
   ``template``/``constraint`` tag key must be declared in
   catalog.CAPPED_CARDINALITY_VIEWS (i.e. fed only by the top-K-capped
   cost-ledger collector), and the collector must actually cap — an
   uncapped per-template label explodes Prometheus cardinality on a
   500-template cluster.
6. Wire-stage conformance: the front door's stable
   WIRE_STAGES set must match the documented table in docs/tracing.md,
   and every ``STAGE_*`` constant the module defines must be listed in
   WIRE_STAGES — an undocumented or unlisted stage breaks the
   stage-breakdown contract bench.py's wire-path section reports on.
7. Federated-format invariants: merging N replica scrapes
   through obs/fleetobs.py must preserve the classic exposition
   discipline — ONE HELP/TYPE header per family, no exemplars, no
   ``# EOF`` — inject ``replica_id`` into unlabelled remote samples, and
   leave samples that already carry a replica_id untouched.
8. Flight-recorder conformance: every event type in
   obs/flightrec.py EVENT_TYPES must be documented in
   docs/observability.md (the incident-chronology table is an operator
   contract), every documented ``/debug/*`` endpoint the shared router
   serves must appear there too, and the route ledger's REASONS must
   each be documented in docs/metrics.md (the route_decisions_total
   reason taxonomy).

9. Decision-log conformance: the record schema
   (decisionlog.RECORD_FIELDS) and decision taxonomy
   (decisionlog.CLASSES) must each be documented in
   docs/decision-logs.md, and a live admission record must emit no
   field outside the declared schema — the archive format is the replay
   tool's input contract.

10. Reactor-observability conformance: the `evloop_stall`
    flight-recorder event type must be declared, the `evloop.*` fault
    points registered AND documented in docs/failure-modes.md, every
    `evloop_*`/`wire_*` view documented in docs/metrics.md,
    /debug/connz routed and mentioned in docs/observability.md, and the
    reactor-health section present in docs/fleet.md — the flight deck
    is an operator contract like every other surface here.

11. Port-only series: every cache a port module records
    (``record_cache("<name>", ...)``, such as the kernels' sealed build
    cache) that docs/metrics.md does not list is documented in
    README.md's port section as ``cache="<name>"``; the JAX package's
    docs stay the JAX package's.

The hot-path list names the port's files: it has no ops/xlacache.py,
ops/asynccompile.py or ops/aotcache.py (the kernels' sealed build cache
in device.py takes their place) and adds obs/devprof.py.
``--torch-device`` (default cuda) names the device the port's drills run
on: the checks are static, and a card asked for and missing raises
instead of running on the CPU, as every ``check_*_torch.py`` does.

Run: python tools/check_observability_torch.py [--torch-device cuda|cpu]
(exit 0 clean, 1 with findings)
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules on (or adjacent to) the admission/audit hot paths where span
# or stage timing happens; extend when instrumenting new modules
HOT_PATH_MODULES = (
    "gatekeeper_tpu_torch/obs/trace.py",
    "gatekeeper_tpu_torch/obs/__init__.py",
    "gatekeeper_tpu_torch/obs/costs.py",
    "gatekeeper_tpu_torch/obs/slo.py",
    "gatekeeper_tpu_torch/obs/debug.py",
    "gatekeeper_tpu_torch/obs/profiler.py",
    "gatekeeper_tpu_torch/obs/fleetobs.py",
    "gatekeeper_tpu_torch/obs/flightrec.py",
    "gatekeeper_tpu_torch/obs/routeledger.py",
    "gatekeeper_tpu_torch/obs/compilestats.py",
    "gatekeeper_tpu_torch/obs/decisionlog.py",
    "gatekeeper_tpu_torch/obs/brownout.py",
    "gatekeeper_tpu_torch/obs/reactorobs.py",
    "gatekeeper_tpu_torch/obs/devprof.py",
    "gatekeeper_tpu_torch/fleet/frontdoor.py",
    "gatekeeper_tpu_torch/fleet/evloop.py",
    "gatekeeper_tpu_torch/fleet/evdoor.py",
    "gatekeeper_tpu_torch/fleet/wirelistener.py",
    "gatekeeper_tpu_torch/metrics/views.py",
    "gatekeeper_tpu_torch/metrics/exporter.py",
    "gatekeeper_tpu_torch/webhook/server.py",
    "gatekeeper_tpu_torch/webhook/policy.py",
    "gatekeeper_tpu_torch/ops/driver.py",
    "gatekeeper_tpu_torch/ops/npside.py",
    "gatekeeper_tpu_torch/ops/deltasweep.py",
    "gatekeeper_tpu_torch/faults/plane.py",
    "gatekeeper_tpu_torch/audit/manager.py",
    "gatekeeper_tpu_torch/metrics/catalog.py",
    "gatekeeper_tpu_torch/logging.py",
)

_WALL_OK = "wall-clock: ok"
_TIME_CALL = re.compile(r"\btime\.time\(\)|\b_time\.time\(\)")


def check_measures_bound() -> list:
    from gatekeeper_tpu_torch.metrics import catalog
    from gatekeeper_tpu_torch.metrics.views import Measure

    views = catalog.catalog_views()
    bound = {v.measure.name for v in views}
    problems = []
    for attr in dir(catalog):
        m = getattr(catalog, attr)
        if isinstance(m, Measure) and m.name not in bound:
            problems.append(
                f"measure {m.name!r} ({attr}) is not bound to any View in "
                "catalog_views() — recordings against it export nothing"
            )
    return problems


def check_metrics_documented() -> list:
    from gatekeeper_tpu_torch.metrics import catalog

    doc_path = os.path.join(REPO, "docs", "metrics.md")
    try:
        with open(doc_path) as f:
            doc = f.read()
    except OSError as e:
        return [f"docs/metrics.md unreadable: {e}"]
    problems = []
    for v in catalog.catalog_views():
        if f"`{v.name}`" not in doc and v.name not in doc:
            problems.append(
                f"exported metric {v.name!r} is not documented in "
                "docs/metrics.md"
            )
    return problems


def check_monotonic_span_timing() -> list:
    problems = []
    for rel in HOT_PATH_MODULES:
        path = os.path.join(REPO, rel)
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError as e:
            problems.append(f"hot-path module {rel} unreadable: {e}")
            continue
        for i, line in enumerate(lines, 1):
            if _TIME_CALL.search(line) and _WALL_OK not in line:
                problems.append(
                    f"{rel}:{i}: time.time() in a hot-path module — span/"
                    "stage timing must use a monotonic clock "
                    "(perf_counter/monotonic); annotate genuine epoch "
                    f"timestamps with '# {_WALL_OK}'"
                )
    return problems


_EXEMPLAR_RE = re.compile(
    r' # \{trace_id="[0-9a-f]{32}"\} [0-9.e+-]+ [0-9]+\.[0-9]+$'
)


def check_exemplar_wellformed() -> list:
    """Render a synthetic registry through both exposition formats and
    verify the exemplar contract."""
    from gatekeeper_tpu_torch.metrics.exporter import (
        render_openmetrics,
        render_prometheus,
    )
    from gatekeeper_tpu_torch.metrics.views import (
        AGG_DISTRIBUTION,
        Measure,
        Registry,
        View,
    )

    problems = []
    reg = Registry()
    m = Measure("exemplar_check_seconds", "synthetic", "s")
    reg.register(View("exemplar_check_seconds", m, AGG_DISTRIBUTION,
                      buckets=(0.01, 0.1, 1.0)))
    trace_id = "ab" * 16
    reg.record(m, 0.05, exemplar_trace_id=trace_id)
    reg.record(m, 5.0, exemplar_trace_id=trace_id)
    om = render_openmetrics(reg)
    if not om.endswith("# EOF\n"):
        problems.append(
            "OpenMetrics rendering does not terminate with '# EOF'"
        )
    ex_lines = [ln for ln in om.splitlines() if " # {" in ln]
    if len(ex_lines) != 2:
        problems.append(
            f"expected 2 exemplar-carrying bucket lines, got {len(ex_lines)}"
        )
    for ln in ex_lines:
        if "_bucket{" not in ln:
            problems.append(f"exemplar on a non-bucket line: {ln!r}")
        if not _EXEMPLAR_RE.search(ln):
            problems.append(f"malformed exemplar: {ln!r}")
    classic = render_prometheus(reg)
    if " # {" in classic or "# EOF" in classic:
        problems.append(
            "classic text format must carry neither exemplars nor '# EOF'"
        )
    return problems


_CARDINALITY_TAGS = {"template", "constraint"}


def check_label_cardinality() -> list:
    """Every view with a template/constraint label must be declared
    top-K-capped, and the cost-ledger collector must actually cap."""
    from gatekeeper_tpu_torch.metrics import catalog
    from gatekeeper_tpu_torch.metrics.views import Registry
    from gatekeeper_tpu_torch.obs.costs import OTHER, CostLedger

    problems = []
    declared = set(getattr(catalog, "CAPPED_CARDINALITY_VIEWS", ()))
    view_names = set()
    for v in catalog.catalog_views():
        view_names.add(v.name)
        if set(v.tag_keys) & _CARDINALITY_TAGS and v.name not in declared:
            problems.append(
                f"view {v.name!r} carries a {sorted(_CARDINALITY_TAGS)} "
                "label but is not declared in "
                "catalog.CAPPED_CARDINALITY_VIEWS — per-template labels "
                "must be top-K-capped"
            )
    for name in declared - view_names:
        problems.append(
            f"CAPPED_CARDINALITY_VIEWS names unknown view {name!r}"
        )
    # functional check: K+2 templates through a top-K=2 ledger must export
    # at most K individual template labels plus the 'other' rollup
    ledger = CostLedger(top_k=2)
    for i in range(4):
        ledger.record_dispatch({f"T{i}": 1}, 0.001, 10)
    reg = Registry()
    catalog.register_catalog(reg)
    ledger.collect(reg)
    labels = {k[0] for k in reg.view_rows("cost_device_ms")}
    if len(labels - {OTHER}) > 2 or OTHER not in labels:
        problems.append(
            "cost-ledger collector exported uncapped template labels: "
            f"{sorted(labels)}"
        )
    return problems


def check_wire_stages() -> list:
    """The front door's WIRE_STAGES set vs its own STAGE_* constants and
    the docs/tracing.md stage table."""
    from gatekeeper_tpu_torch.fleet import frontdoor

    problems = []
    stages = set(frontdoor.WIRE_STAGES)
    declared = {
        v for k, v in vars(frontdoor).items()
        if k.startswith("STAGE_") and isinstance(v, str)
    }
    for s in declared - stages:
        problems.append(
            f"frontdoor stage constant {s!r} is not listed in "
            "WIRE_STAGES — it would be invisible to the stage-breakdown "
            "contract"
        )
    for s in stages - declared:
        problems.append(
            f"WIRE_STAGES entry {s!r} has no STAGE_* constant in "
            "fleet/frontdoor.py"
        )
    doc_path = os.path.join(REPO, "docs", "tracing.md")
    try:
        with open(doc_path) as f:
            doc = f.read()
    except OSError as e:
        return problems + [f"docs/tracing.md unreadable: {e}"]
    for s in sorted(stages):
        if f"`{s}`" not in doc:
            problems.append(
                f"wire stage {s!r} is not documented in docs/tracing.md "
                "(the stable stage-name table)"
            )
    return problems


def check_federated_format() -> list:
    """Merge synthetic replica scrapes through obs/fleetobs.py and
    verify the classic exposition invariants survive federation."""
    from gatekeeper_tpu_torch.metrics.exporter import render_prometheus
    from gatekeeper_tpu_torch.metrics.views import (
        AGG_COUNT,
        AGG_DISTRIBUTION,
        Measure,
        Registry,
        View,
    )
    from gatekeeper_tpu_torch.obs.fleetobs import merge_families, render_families

    problems = []
    reg = Registry()
    m = Measure("fed_check_seconds", "synthetic", "s")
    c = Measure("fed_check_reqs", "synthetic")
    reg.register(
        View("fed_check_seconds", m, AGG_DISTRIBUTION, buckets=(0.1, 1.0)),
        View("fed_check_total", c, AGG_COUNT, tag_keys=("outcome",)),
    )
    reg.record(m, 0.05, exemplar_trace_id="cd" * 16)
    reg.record(c, 1.0, {"outcome": "ok"})
    local = render_prometheus(reg)
    remote = (
        "# HELP gatekeeper_fed_check_total synthetic\n"
        "# TYPE gatekeeper_fed_check_total counter\n"
        'gatekeeper_fed_check_total{outcome="ok"} 3\n'
        'gatekeeper_fed_check_total{outcome="ok",replica_id="rX"} 2\n'
        "# HELP gatekeeper_fed_up synthetic\n"
        "# TYPE gatekeeper_fed_up gauge\n"
        "gatekeeper_fed_up 1\n"
    )
    out = render_families(merge_families(
        local, [("r0", remote), ("r1", remote)]
    ))
    if "# EOF" in out or " # {" in out:
        problems.append(
            "federated output leaked an OpenMetrics construct "
            "(exemplar or # EOF) into the classic format"
        )
    lines = out.splitlines()
    for kind in ("HELP", "TYPE"):
        seen = [ln.split()[2] for ln in lines
                if ln.startswith(f"# {kind} ")]
        dupes = {n for n in seen if seen.count(n) > 1}
        if dupes:
            problems.append(
                f"federated output repeats # {kind} for {sorted(dupes)} "
                "— one header per family is the classic contract"
            )
    if 'gatekeeper_fed_up{replica_id="r0"} 1' not in out \
            or 'gatekeeper_fed_up{replica_id="r1"} 1' not in out:
        problems.append(
            "federation did not inject replica_id into unlabelled "
            "remote samples"
        )
    if 'outcome="ok",replica_id="rX"' not in out:
        problems.append(
            "federation rewrote a sample that already carried its own "
            "replica_id label (replica-stamped series are authoritative)"
        )
    if out.count('gatekeeper_fed_check_total{outcome="ok"} 1') != 1:
        problems.append(
            "federation lost or duplicated the parent's own samples"
        )
    return problems


def check_flightrec_conformance() -> list:
    """The flight recorder's event-type table, the shared router's
    endpoint surface, and the route ledger's reason taxonomy must all be
    documented — they are operator contracts."""
    from gatekeeper_tpu_torch.obs import flightrec, routeledger
    from gatekeeper_tpu_torch.obs.debug import get_router

    problems = []
    doc_path = os.path.join(REPO, "docs", "observability.md")
    try:
        with open(doc_path) as f:
            doc = f.read()
    except OSError as e:
        return [f"docs/observability.md unreadable: {e}"]
    for etype in flightrec.EVENT_TYPES:
        if f"`{etype}`" not in doc:
            problems.append(
                f"flight-recorder event type {etype!r} is not documented "
                "in docs/observability.md (the incident-chronology table)"
            )
    for endpoint in get_router().endpoints():
        if endpoint not in doc:
            problems.append(
                f"debug endpoint {endpoint!r} is not mentioned in "
                "docs/observability.md (the surface map)"
            )
    metrics_path = os.path.join(REPO, "docs", "metrics.md")
    try:
        with open(metrics_path) as f:
            mdoc = f.read()
    except OSError as e:
        return problems + [f"docs/metrics.md unreadable: {e}"]
    for reason in routeledger.REASONS:
        if f"`{reason}`" not in mdoc:
            problems.append(
                f"route-decision reason {reason!r} is not documented in "
                "docs/metrics.md (route_decisions_total taxonomy)"
            )
    return problems


def check_decisionlog_conformance() -> list:
    """The decision log's record schema and taxonomy are operator (and
    replay-tool) contracts: every field a record may carry
    (decisionlog.RECORD_FIELDS) and every decision class
    (decisionlog.CLASSES) must be documented in docs/decision-logs.md,
    and a live admission record must emit no field outside the declared
    schema — an undocumented field silently changes the archive format
    replay depends on."""
    from gatekeeper_tpu_torch.obs import decisionlog

    problems = []
    doc_path = os.path.join(REPO, "docs", "decision-logs.md")
    try:
        with open(doc_path) as f:
            doc = f.read()
    except OSError as e:
        return [f"docs/decision-logs.md unreadable: {e}"]
    for field in decisionlog.RECORD_FIELDS:
        if f"`{field}`" not in doc:
            problems.append(
                f"decision-record field {field!r} is not documented in "
                "docs/decision-logs.md (the record-schema table)"
            )
    for dclass in decisionlog.CLASSES:
        if f"`{dclass}`" not in doc:
            problems.append(
                f"decision class {dclass!r} is not documented in "
                "docs/decision-logs.md (the taxonomy table)"
            )
    # functional half: a real record must stay inside the schema
    log = decisionlog.DecisionLog()

    class _Resp:
        allowed = False
        code = 403
        message = "check"
        annotations = None

    log.record_admission({"uid": "schema-check"}, _Resp(), 0.001,
                         budget_s=0.1)
    recs = log.snapshot()["records"]
    if not recs:
        problems.append("decision log dropped a synthetic record "
                        "(schema check could not run)")
    else:
        for field in recs[0]:
            if field not in decisionlog.RECORD_FIELDS:
                problems.append(
                    f"admission records emit undeclared field {field!r} "
                    "— add it to decisionlog.RECORD_FIELDS and the "
                    "docs/decision-logs.md schema table"
                )
    return problems


def check_reactor_conformance() -> list:
    """Reactor flight-deck contracts: event type declared,
    fault points registered + documented, metrics + endpoint + docs
    sections present."""
    from gatekeeper_tpu_torch import faults
    from gatekeeper_tpu_torch.metrics import catalog
    from gatekeeper_tpu_torch.obs import flightrec
    from gatekeeper_tpu_torch.obs.debug import get_router

    problems = []
    if getattr(flightrec, "EVLOOP_STALL", None) not in flightrec.EVENT_TYPES:
        problems.append(
            "flightrec.EVLOOP_STALL missing from EVENT_TYPES — the stall "
            "watchdog's incidents would fail the recorder's type check"
        )
    fm_path = os.path.join(REPO, "docs", "failure-modes.md")
    try:
        with open(fm_path) as f:
            fmdoc = f.read()
    except OSError as e:
        return problems + [f"docs/failure-modes.md unreadable: {e}"]
    for point in ("evloop.slow_callback", "evloop.stall"):
        if point not in faults.ALL_POINTS:
            problems.append(
                f"fault point {point!r} is not registered in "
                "faults.ALL_POINTS — gklint's unknown-fault-point rule "
                "would reject its fire site"
            )
        if f"`{point}`" not in fmdoc:
            problems.append(
                f"fault point {point!r} is not documented in "
                "docs/failure-modes.md (the fault-point table)"
            )
    if "watchdog" not in fmdoc:
        problems.append(
            "docs/failure-modes.md has no stall-watchdog row — the "
            "evloop.stall recovery story is an operator contract"
        )
    view_names = {v.name for v in catalog.catalog_views()}
    expected = {
        "evloop_lag_seconds", "evloop_tick_seconds", "evloop_utilization",
        "evloop_callbacks_per_tick", "evloop_timer_drift_seconds",
        "evloop_slow_callbacks_total", "evloop_stalls_total",
        "wire_chunks_total", "wire_chunk_records", "wire_bytes_total",
        "wire_decode_errors_total", "wire_reconnects_total",
        "wire_backlog_stall_seconds",
    }
    for name in sorted(expected - view_names):
        problems.append(
            f"reactor/wire view {name!r} is missing from catalog_views() "
            "— the flight-deck metric set is incomplete"
        )
    if "/debug/connz" not in get_router().endpoints():
        problems.append(
            "/debug/connz is not routed on the shared debug router"
        )
    fleet_path = os.path.join(REPO, "docs", "fleet.md")
    try:
        with open(fleet_path) as f:
            fleetdoc = f.read()
    except OSError as e:
        return problems + [f"docs/fleet.md unreadable: {e}"]
    if "reactor health" not in fleetdoc.lower():
        problems.append(
            "docs/fleet.md has no reactor-health section — the flight "
            "deck's operator story must live next to the edge it watches"
        )
    return problems


_CACHE_CALL = re.compile(r'record_cache\(\s*"(\w+)"')
PORT_SECTION = "## PyTorch / CUDA port"


def check_port_series_documented() -> list:
    """The caches only the port records are its own operator contract:
    each name a port module passes to record_cache that docs/metrics.md
    does not list must be documented in README.md's port section as
    ``cache="<name>"`` (cache_requests_total's label value)."""
    names = set()
    for root, _dirs, files in os.walk(os.path.join(REPO,
                                                   "gatekeeper_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names.update(_CACHE_CALL.findall(fh.read()))
    if not names:
        return ["no record_cache call found in gatekeeper_tpu_torch/ — "
                "the cache metric lost its feeds"]
    try:
        with open(os.path.join(REPO, "docs", "metrics.md")) as f:
            mdoc = f.read()
        with open(os.path.join(REPO, "README.md")) as f:
            readme = f.read()
    except OSError as e:
        return [f"docs unreadable: {e}"]
    port = readme[readme.find(PORT_SECTION):] if PORT_SECTION in readme \
        else ""
    return [
        f"cache {name!r} is recorded only by the port and not documented "
        f"in README.md's port section as cache=\"{name}\""
        for name in sorted(names)
        if f"`{name}`" not in mdoc and f'cache="{name}"' not in port
    ]


def run_checks() -> list:
    sys.path.insert(0, REPO)
    return (
        check_measures_bound()
        + check_metrics_documented()
        + check_monotonic_span_timing()
        + check_exemplar_wellformed()
        + check_label_cardinality()
        + check_wire_stages()
        + check_federated_format()
        + check_flightrec_conformance()
        + check_decisionlog_conformance()
        + check_reactor_conformance()
        + check_port_series_documented()
    )


def main(argv=None) -> int:
    import argparse

    from gatekeeper_tpu_torch.device import select_device

    ap = argparse.ArgumentParser(prog="check_observability_torch.py")
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    select_device(ap.parse_args(argv).torch_device)
    problems = run_checks()
    for p in problems:
        print(f"check_observability: {p}", file=sys.stderr)
    if problems:
        print(f"check_observability: {len(problems)} problem(s)",
              file=sys.stderr)
        return 1
    print("check_observability: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
