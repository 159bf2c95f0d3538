"""Audit manager — the periodic full-cluster sweep (reference
pkg/audit/manager.go).

Two modes, as the reference:
  from-cache  — one engine Audit over the replicated inventory
                (manager.go:195-207); with the TPU driver this is the
                batched constraints×resources device sweep
  discovery   — list every listable GVK from the API store and review each
                object (manager.go:233-404), with pagination
                (--audit-chunk-size), per-run namespace cache
                (manager.go:96-115) and kind pre-filtering
                (--audit-match-kind-only, manager.go:282-331)

TPU-first departure: discovery mode batches reviews through
client.review_batch — one device dispatch per chunk — instead of the
reference's serial per-object Review loop (manager.go:361-389).

Results land on each constraint's status.violations capped at
--constraint-violations-limit via a retrying update loop
(manager.go:555-620, 643-701).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from datetime import datetime, timezone

from .. import logging as gklog
from ..client.drivers import constraint_match_spec
from ..kube.inmem import GVK, InMemoryKube, NotFound
from ..obs import slo as obsslo
from ..obs import trace as obstrace
from ..process.excluder import AUDIT, Excluder
from ..target.target import AugmentedUnstructured
from ..util import KNOWN_ENFORCEMENT_ACTIONS, get_enforcement_action
from ..util import join_thread

log = gklog.get("audit")

CONSTRAINTS_GROUP = "constraints.gatekeeper.sh"
CONSTRAINTS_VERSION = "v1beta1"
TEMPLATES_CRD_NAME = "constrainttemplates.templates.gatekeeper.sh"
CRD_GVK = ("apiextensions.k8s.io", "v1", "CustomResourceDefinition")

MSG_SIZE = 256  # manager.go:41 msgSize
DEFAULT_AUDIT_INTERVAL = 60.0
DEFAULT_VIOLATIONS_LIMIT = 20
DEFAULT_REVIEW_BATCH = 512  # device dispatch width in discovery mode

# groups never audited as cluster resources (gatekeeper's own APIs)
_SKIP_GROUPS = {
    "templates.gatekeeper.sh",
    CONSTRAINTS_GROUP,
    "config.gatekeeper.sh",
    "status.gatekeeper.sh",
    "apiextensions.k8s.io",
}


@dataclass
class StatusViolation:
    """status.violations entry (manager.go StatusViolation)."""

    kind: str
    name: str
    namespace: str
    message: str
    enforcement_action: str

    def to_dict(self) -> dict:
        out = {
            "kind": self.kind,
            "name": self.name,
            "message": self.message,
            "enforcementAction": self.enforcement_action,
        }
        if self.namespace:
            out["namespace"] = self.namespace
        return out


def dt_rfc3339() -> str:
    """UTC RFC3339 timestamp (manager.go:148)."""
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def truncate(msg: str, size: int = MSG_SIZE) -> str:
    if len(msg) <= size:
        return msg
    if size > 3:
        size -= 3
    return msg[:size] + "..."


class AuditManager:
    def __init__(
        self,
        kube: InMemoryKube,
        client,                      # gatekeeper_tpu_torch.client.Client
        excluder: Optional[Excluder] = None,
        reporter=None,
        interval_s: float = DEFAULT_AUDIT_INTERVAL,
        violations_limit: int = DEFAULT_VIOLATIONS_LIMIT,
        chunk_size: int = 0,
        from_cache: bool = False,
        match_kind_only: bool = False,
        emit_audit_events: bool = False,
        event_recorder: Optional[Callable[[dict], None]] = None,
        gk_namespace: str = "gatekeeper-system",
        review_batch: int = DEFAULT_REVIEW_BATCH,
        require_crd: bool = False,
        exact_totals: bool = False,
        snapshotter=None,
    ):
        self.kube = kube
        self.client = client
        self.excluder = excluder or Excluder()
        self.reporter = reporter
        self.interval_s = interval_s
        self.violations_limit = violations_limit
        self.chunk_size = chunk_size
        self.from_cache = from_cache
        self.match_kind_only = match_kind_only
        self.emit_audit_events = emit_audit_events
        self.event_recorder = event_recorder
        self.gk_namespace = gk_namespace
        self.review_batch = review_batch
        self.require_crd = require_crd
        # --audit-exact-totals: render EVERY violating cell so
        # status.totalViolations counts violation results exactly (reference
        # manager.go:188 semantics).  Off by default: the from-cache sweep
        # uses the driver's cap-aware device reduction, whose totals are
        # exact below the cap and "violating resources" at/over it.
        self.exact_totals = exact_totals
        # failure visibility: a silently failing audit (bare except in the
        # loop) must be observable — last-run status + consecutive-failure
        # streak, exported via Reporters.report_audit_status
        self.consecutive_failures = 0
        self.last_run_status: Optional[str] = None  # "ok" | "error"
        # warm-resume persistence (gatekeeper_tpu_torch/snapshot/): a completed
        # sweep is the one moment the packed inventory is exactly synced
        # to the store, so each success re-arms the background writer
        self.snapshotter = snapshotter
        # decision-log transition basis (obs/decisionlog.py): the
        # previous sweep's reported violation keys, diffed each sweep so
        # the archive records new/resolved DELTAS, never the full set
        self._prev_violation_keys: Optional[set] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- loop (manager.go:406-431) ----------------------------------------

    def start(self):
        # idempotent: a second start() must not spawn a second audit loop
        # (two concurrent sweeps would race the driver and double every
        # status write) nor orphan the first thread
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="audit", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            join_thread(self._thread, 2.0, "audit loop")
            self._thread = None

    def _loop(self):
        from ..obs import brownout as _brownout

        while not self._stop.wait(timeout=self.interval_s):
            if _brownout.defer_background():
                # brownout ladder level >= 1 (docs/failure-modes.md):
                # a sweep competes with saturated admissions for the
                # same cores, so it steps aside — a skipped iteration,
                # not a cancelled loop; freshness staleness is visible
                # via audit_last_run_age_s and the SLO freshness probe
                log.info("audit sweep deferred by brownout ladder")
                continue
            self.run_once_guarded()

    def run_once_guarded(self) -> bool:
        """One audit sweep with failure accounting: the loop body.  Never
        raises; returns True on success.  Failures keep the loop alive
        (kube outage, device fault) but are no longer silent — the status
        and streak land in metrics and on this object."""
        try:
            self.audit_once()
        except Exception:
            self.consecutive_failures += 1
            self.last_run_status = "error"
            log.exception(
                "audit failed (%d consecutive)", self.consecutive_failures
            )
            self._report_status(False)
            return False
        self.consecutive_failures = 0
        self.last_run_status = "ok"
        self._report_status(True)
        # freshness anchor for the SLO engine's audit_last_run_age_s
        # gauge and audit_freshness probe (obs/slo.py) — success only:
        # a failing loop must read as stale, not fresh
        obsslo.observe_audit_run()
        if self.snapshotter is not None:
            try:
                self.snapshotter.notify_sweep()
            except Exception:
                log.exception("could not arm the snapshotter")
        return True

    def _report_status(self, ok: bool):
        if self.reporter is None:
            return
        try:
            self.reporter.report_audit_status(ok, self.consecutive_failures)
        except Exception:
            log.exception("could not report audit status")

    # ---- one sweep (manager.go:146-230) -----------------------------------

    def audit_once(self) -> Dict[str, List[StatusViolation]]:
        t0 = time.monotonic()
        timestamp = dt_rfc3339()
        # root span of the audit trace: the driver's sweep stages (pack /
        # per-shard dispatch / fetch / render) parent to it via the
        # context var since the whole sweep runs on this thread.  Manual
        # enter/exit (instead of re-indenting the body): __enter__ is
        # immediately followed by the try whose finally __exit__s with
        # the live exc_info, so the span can neither leak on this
        # long-lived thread nor lose error attribution
        _span_ctx = obstrace.root_span(
            "audit", audit_id=timestamp,
            mode="from-cache" if self.from_cache else "discovery",
        )
        _span = _span_ctx.__enter__()
        try:
            gklog.log_event(log, "auditing constraints and violations",
                            **{gklog.EVENT_TYPE: "audit_started",
                               gklog.AUDIT_ID: timestamp})
            if self.reporter:
                self.reporter.report_audit_last_run(time.time())  # wall-clock: ok (epoch gauge)
            if self.require_crd and not self._crd_exists():
                log.info("audit exits, required crd has not been deployed")
                return {}
            constraint_kinds = self._constraint_kinds()
            if not constraint_kinds:
                log.info("no constraint kinds found")
                return {}

            update_lists: Dict[str, List[StatusViolation]] = {}
            totals_per_constraint: Dict[str, int] = {}
            # totals are exact (reference totalViolations semantics) unless
            # the capped driver reduction reports an approximation for a
            # constraint ("resources": device-candidate count past the cap)
            totals_exact: Dict[str, bool] = {}
            totals_per_action: Dict[str, int] = {
                a: 0 for a in KNOWN_ENFORCEMENT_ACTIONS
            }

            if self.from_cache:
                capped = (
                    not self.exact_totals
                    and hasattr(self.client, "audit_capped")
                )
                if capped:
                    responses, driver_totals = self.client.audit_capped(
                        self.violations_limit
                    )
                    results = responses.results()
                else:
                    results = self.client.audit().results()
                # the sweep owner surfaces the sharded-path shape: mesh
                # width, per-shard row work and (steady state) the
                # O(churn) delta row count ride the audit root span and
                # the audit_finished event, so an operator can read the
                # pipeline's behavior off one trace
                self._annotate_sweep(_span)
                self._add_results(
                    results, update_lists, totals_per_constraint,
                    totals_per_action, timestamp,
                )
                if capped:
                    # driver-reported totals override the (capped) result
                    # iteration counts; the status key must match what
                    # _add_results derived from the constraint object
                    rendered_per: Dict[Tuple[str, str], int] = {}
                    for r in results:
                        kk = (r.constraint.get("kind", ""),
                              (r.constraint.get("metadata") or {}).get("name", ""))
                        rendered_per[kk] = rendered_per.get(kk, 0) + 1
                    for kk, (n, how) in driver_totals.items():
                        cobj = None
                        if hasattr(self.client, "get_constraint"):
                            cobj = self.client.get_constraint(*kk)
                        key = (
                            self._constraint_key(cobj) if cobj
                            else f"{kk[0]}//{kk[1]}"
                        )
                        totals_per_constraint[key] = n
                        totals_exact[key] = how == "exact"
                        extra = n - rendered_per.get(kk, 0)
                        if extra > 0:
                            a = get_enforcement_action(cobj or {})
                            totals_per_action[a] = (
                                totals_per_action.get(a, 0) + extra
                            )
            else:
                self._audit_resources(
                    update_lists, totals_per_constraint, totals_per_action,
                    timestamp,
                )

            for key in update_lists:
                gklog.log_event(
                    log, "audit results for constraint",
                    **{gklog.EVENT_TYPE: "constraint_audited",
                       gklog.CONSTRAINT_NAME: key.rsplit("/", 1)[-1],
                       "total_violations": totals_per_constraint.get(key, 0)},
                )
            if self.reporter:
                for action, n in totals_per_action.items():
                    self.reporter.report_total_violations(action, n)

            with obstrace.span("audit.status_write",
                               stage=obstrace.STATUS_WRITE,
                               constraints=len(update_lists)):
                self._write_audit_results(
                    constraint_kinds, update_lists, timestamp,
                    totals_per_constraint, totals_exact,
                )
            self._record_transitions(update_lists, timestamp)
            return update_lists
        finally:
            dur = time.monotonic() - t0
            if self.reporter:
                self.reporter.report_audit_duration(dur)
            gklog.log_event(log, "auditing is complete",
                            **{gklog.EVENT_TYPE: "audit_finished",
                               gklog.AUDIT_ID: timestamp,
                               **self._sweep_shape()})
            import sys as _sys

            _span_ctx.__exit__(*_sys.exc_info())

    # ---- helpers -----------------------------------------------------------

    def _record_transitions(self, update_lists, timestamp):
        """Decision-log feed (obs/decisionlog.py): diff this sweep's
        REPORTED violation set (update_lists — per-constraint capped at
        violations_limit, the same set the status writes publish)
        against the previous sweep's, and record only the new/resolved
        deltas.  A restart's first sweep reports everything as new (no
        basis).  Guarded: provenance must never fail the sweep."""
        try:
            from ..obs import decisionlog as obsdlog

            # the O(reported violations) digest + diff below is pure
            # decision-log feed work — skip it entirely when recording
            # is off (the next enabled sweep reports all-new, same as a
            # restart's first sweep)
            if not obsdlog.get_log().record_enabled:
                self._prev_violation_keys = None
                return
            cur = set()
            for ck, violations in update_lists.items():
                for v in violations:
                    cur.add((ck, v.kind, v.namespace, v.name,
                             obsdlog.message_digest(v.message)))
            prev = self._prev_violation_keys
            self._prev_violation_keys = cur
            if prev is None:
                prev = set()
            new = sorted(cur - prev)
            resolved = sorted(prev - cur)
            if new or resolved:
                obsdlog.record_audit_transitions(new, resolved, timestamp)
        except Exception:
            log.exception("could not record decision-log transitions")

    # last_sweep_stats keys the audit owner republishes (sharded-path
    # shape: mesh width, per-shard work, steady-state churn row count)
    _SWEEP_SHAPE_KEYS = (
        "shards", "rows_per_shard", "rows", "delta_rows", "delta_shards",
    )

    def _sweep_shape(self) -> Dict[str, float]:
        """The driver's last sweep shape, filtered to the sharded-path
        keys; {} when the engine exposes no sweep stats (interp tier)."""
        drv = getattr(self.client, "driver", None)
        stats = getattr(drv, "last_sweep_stats", None)
        if not isinstance(stats, dict):
            return {}
        return {k: stats[k] for k in self._SWEEP_SHAPE_KEYS if k in stats}

    def _annotate_sweep(self, span):
        try:
            shape = self._sweep_shape()
            if shape:
                span.set_attrs(**shape)
        except Exception:  # telemetry must never fail the sweep
            log.exception("could not annotate the audit span")

    def _crd_exists(self) -> bool:
        try:
            self.kube.get(CRD_GVK, TEMPLATES_CRD_NAME)
            return True
        except NotFound:
            return False

    def _constraint_kinds(self) -> List[GVK]:
        """getAllConstraintKinds (manager.go:438-460): every constraint kind
        served under constraints.gatekeeper.sh/v1beta1.  Discovery here is
        the engine's installed-template list unioned with kinds present in
        the API store."""
        kinds = {k for k in self.client.templates()}
        for gvk in self.kube.list_gvks():
            if gvk[0] == CONSTRAINTS_GROUP:
                kinds.add(gvk[2])
        return [(CONSTRAINTS_GROUP, CONSTRAINTS_VERSION, k) for k in sorted(kinds)]

    def _constraint_key(self, constraint: dict) -> str:
        """selfLink analogue: unique key per constraint object."""
        meta = constraint.get("metadata") or {}
        return f"{constraint.get('kind', '')}/{meta.get('namespace', '')}/{meta.get('name', '')}"

    def _matched_kinds(self, constraint_kinds: List[GVK]) -> set:
        """Kind pre-filter from constraint spec.match.kinds
        (--audit-match-kind-only, manager.go:282-331)."""
        if not self.match_kind_only:
            return {"*"}
        matched = set()
        for cgvk in constraint_kinds:
            for constraint in self.kube.list(cgvk):
                kinds_list = constraint_match_spec(constraint).get("kinds")
                if kinds_list is None:
                    return {"*"}
                for entry in kinds_list:
                    if not isinstance(entry, dict):
                        continue
                    for kk in entry.get("kinds") or []:
                        if kk in ("", "*"):
                            return {"*"}
                        matched.add(kk)
        return matched

    def _audit_resources(
        self, update_lists, totals_per_constraint, totals_per_action,
        timestamp,
    ):
        """Discovery-mode sweep with batched device dispatches.  The
        inventory span covers the whole list+review walk (the listing
        interleaves with dispatch flushes, so the driver's pack/dispatch
        spans nest inside it — audit stages overlap by design, unlike the
        webhook's disjoint stages; docs/tracing.md)."""
        constraint_kinds = self._constraint_kinds()
        matched = self._matched_kinds(constraint_kinds)
        ns_cache: Dict[str, Optional[dict]] = {}

        def lookup_ns(name: str) -> Optional[dict]:
            if name not in ns_cache:
                try:
                    ns_cache[name] = self.kube.get(("", "v1", "Namespace"), name)
                except NotFound:
                    ns_cache[name] = None
            return ns_cache[name]

        pending: List[AugmentedUnstructured] = []

        def flush():
            if not pending:
                return
            for resp in self.client.review_batch(list(pending)):
                self._add_results(
                    resp.results(), update_lists, totals_per_constraint,
                    totals_per_action, timestamp,
                )
            pending.clear()

        with obstrace.span("audit.inventory", stage=obstrace.INVENTORY):
            for gvk in self.kube.list_gvks():
                if gvk[0] in _SKIP_GROUPS:
                    continue
                if "*" not in matched and gvk[2] not in matched:
                    continue
                # STREAMED paging (--audit-chunk-size): each page arrives
                # via the kube surface's limit+continue chunking, so host
                # memory is bounded by the chunk size, not the cluster size
                # (reference manager.go:342-396); each page then fills
                # device-width review batches.  Kube clients without
                # list_pages fall back to one full-list page.
                if self.chunk_size and hasattr(self.kube, "list_pages"):
                    pages = self.kube.list_pages(gvk, limit=self.chunk_size)
                else:
                    pages = iter([self.kube.list(gvk)])
                for page in pages:
                    for obj in page:
                        ns = (obj.get("metadata") or {}).get("namespace") or ""
                        # a Namespace object is excluded by its own name —
                        # an excluded namespace shouldn't surface via its
                        # Namespace object either (deliberate tightening of
                        # manager.go:362)
                        if not ns and gvk == ("", "v1", "Namespace"):
                            ns = (obj.get("metadata") or {}).get("name") or ""
                        if self.excluder.is_namespace_excluded(AUDIT, ns):
                            continue
                        ns_obj = lookup_ns(ns) if ns else None
                        pending.append(
                            AugmentedUnstructured(object=obj, namespace=ns_obj)
                        )
                        if len(pending) >= self.review_batch:
                            flush()
            flush()

    def _add_results(
        self, results, update_lists, totals_per_constraint,
        totals_per_action, timestamp,
    ):
        """addAuditResponsesToUpdateLists (manager.go:462-508)."""
        for r in results:
            key = self._constraint_key(r.constraint)
            totals_per_constraint[key] = totals_per_constraint.get(key, 0) + 1
            action = r.enforcement_action
            totals_per_action[action] = totals_per_action.get(action, 0) + 1
            resource = r.resource or {}
            rmeta = resource.get("metadata") or {}
            if len(update_lists.setdefault(key, [])) < self.violations_limit:
                update_lists[key].append(
                    StatusViolation(
                        kind=resource.get("kind", ""),
                        name=rmeta.get("name", ""),
                        namespace=rmeta.get("namespace", "") or "",
                        message=truncate(r.msg),
                        enforcement_action=action,
                    )
                )
            cmeta = r.constraint.get("metadata") or {}
            gklog.log_event(
                log, "audit violation",
                **{gklog.PROCESS: "audit",
                   gklog.EVENT_TYPE: "violation_audited",
                   gklog.CONSTRAINT_NAME: cmeta.get("name", ""),
                   gklog.CONSTRAINT_KIND: r.constraint.get("kind", ""),
                   gklog.CONSTRAINT_ACTION: action,
                   gklog.RESOURCE_KIND: resource.get("kind", ""),
                   gklog.RESOURCE_NAMESPACE: rmeta.get("namespace", ""),
                   gklog.RESOURCE_NAME: rmeta.get("name", ""),
                   gklog.AUDIT_ID: timestamp},
            )
            if self.emit_audit_events and self.event_recorder:
                capi = r.constraint.get("apiVersion", "")
                cgroup, _, cversion = capi.rpartition("/")
                rapi = resource.get("apiVersion", "")
                rgroup, _, rversion = rapi.rpartition("/")
                self.event_recorder({
                    "reason": "AuditViolation",
                    "type": "Warning",
                    "message": (
                        f"Timestamp: {timestamp}, Resource Namespace: "
                        f"{rmeta.get('namespace', '')}, Constraint: "
                        f"{cmeta.get('name', '')}, Message: {r.msg}"
                    ),
                    # annotation set of manager.go:755-770 emitEvent
                    "annotations": {
                        "process": "audit",
                        "auditTimestamp": timestamp,
                        gklog.EVENT_TYPE: "violation_audited",
                        gklog.CONSTRAINT_GROUP: cgroup,
                        gklog.CONSTRAINT_API_VERSION: cversion,
                        gklog.CONSTRAINT_KIND: r.constraint.get("kind", ""),
                        gklog.CONSTRAINT_NAME: cmeta.get("name", ""),
                        gklog.CONSTRAINT_NAMESPACE: cmeta.get("namespace", ""),
                        gklog.CONSTRAINT_ACTION: action,
                        gklog.RESOURCE_GROUP: rgroup,
                        gklog.RESOURCE_API_VERSION: rversion,
                        gklog.RESOURCE_KIND: resource.get("kind", ""),
                        gklog.RESOURCE_NAMESPACE: rmeta.get("namespace", ""),
                        gklog.RESOURCE_NAME: rmeta.get("name", ""),
                    },
                    "namespace": self.gk_namespace,
                })

    def _write_audit_results(
        self, constraint_kinds, update_lists, timestamp, totals_per_constraint,
        totals_exact,
    ):
        """writeAuditResults + updateConstraintLoop (manager.go:510-549,
        643-701): per-constraint status writes with retry/backoff."""
        for cgvk in constraint_kinds:
            remaining = {
                self._constraint_key(c): c for c in self.kube.list(cgvk)
            }
            backoff = 0.05
            for _attempt in range(5):
                for key in list(remaining):
                    try:
                        self._update_constraint_status(
                            remaining[key], update_lists.get(key, []),
                            timestamp, totals_per_constraint.get(key, 0),
                            totals_exact.get(key, True),
                        )
                        del remaining[key]
                    except NotFound:
                        # constraint deleted mid-audit: nothing to update
                        del remaining[key]
                    except Exception:
                        log.exception(
                            "could not update constraint status: %s", key
                        )
                if not remaining:
                    break
                time.sleep(backoff)
                backoff *= 2

    def _update_constraint_status(
        self, constraint: dict, violations: List[StatusViolation],
        timestamp: str, total: int, total_exact: bool = True,
    ):
        """updateConstraintStatus (manager.go:555-620)."""
        meta = constraint.get("metadata") or {}
        gvk = (CONSTRAINTS_GROUP, CONSTRAINTS_VERSION, constraint.get("kind", ""))
        latest = self.kube.get(gvk, meta.get("name", ""),
                               meta.get("namespace", "") or "")
        status = latest.setdefault("status", {})
        status["auditTimestamp"] = timestamp
        status["totalViolations"] = total
        # exact/approximate marker: False only when the cap
        # cut rendering short AND the constraint's vectorized program is not
        # provably count-exact, so the total counts device-candidate
        # resources rather than violations
        status["totalViolationsExact"] = bool(total_exact)
        if violations:
            status["violations"] = [
                v.to_dict() for v in violations[: self.violations_limit]
            ]
        else:
            status.pop("violations", None)
        # Status().Update (manager.go:604): constraint CRDs declare the
        # status subresource, so the write must go via .../status
        self.kube.update(latest, check_version=True, subresource="status")
