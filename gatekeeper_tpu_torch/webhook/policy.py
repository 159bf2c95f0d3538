"""The validation handler — /v1/admit semantics (reference
pkg/webhook/policy.go:142-223).

Order of checks, matching the reference Handle:
  1. gatekeeper's own service account bypass (policy.go:147-149)
  2. DELETE uses OldObject; absent OldObject is a 500 (policy.go:151-166)
  3. gatekeeper resources get dry-run validation: templates through the
     CRD-synthesis compile, constraints against their template CRD
     (policy.go:168-179, 310-360) — user errors are 422, internal 500
  4. namespaces excluded for the webhook process are allowed through
     (policy.go:192-195)
  5. review: trace config lookup, Namespace-kind namespace coercion,
     Namespace augmentation from the cluster (policy.go:363-400)
  6. deny messages only from enforcementAction==deny; dryrun logs/events
     only (policy.go:209-222, 225-291)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .. import logging as gklog
from ..deadline import (
    DeadlineExceeded,
    OverloadShed,
    pop as deadline_pop,
    push as deadline_push,
    remaining as deadline_remaining,
)
from ..obs import decisionlog as obsdlog
from ..obs import slo as obsslo
from ..obs import trace as obstrace
from ..apis.config import CONFIG_NAME, GVK as CONFIG_GVK, parse_config
from ..kube.inmem import InMemoryKube, NotFound
from ..process.excluder import WEBHOOK, Excluder
from ..target.target import AugmentedReview
from ..util import (
    DENY as ACTION_DENY,
    DRYRUN as ACTION_DRYRUN,
    EnforcementActionError,
    get_namespace,
    validate_enforcement_action,
)

SERVICE_ACCOUNT_NAME = "gatekeeper-admin"

TEMPLATE_GROUP = "templates.gatekeeper.sh"
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"

# requestResponse values for the request_count metric (policy.go:134-140)
RESPONSE_ALLOW = "allow"
RESPONSE_DENY = "deny"
RESPONSE_ERROR = "error"
RESPONSE_UNKNOWN = "unknown"

# fixed messages/annotations for the explicit failure decisions so the
# AdmissionReview JSON is exact and testable (tests/test_webhook.py)
DEADLINE_MESSAGE = "admission deadline budget exhausted"
DEADLINE_CODE = 504
SHED_MESSAGE = "admission request shed under overload"
SHED_CODE = 429
FAIL_OPEN_ANNOTATION = "admission.gatekeeper.sh/fail-open"
FAIL_OPEN_DEADLINE = "deadline-exhausted"
FAIL_OPEN_INTERNAL = "internal-error"
FAIL_OPEN_SHED = "overload-shed"

log = gklog.get("webhook")


class NamespaceNotSynced(LookupError):
    """The review's namespace is not in the API store yet — an expected
    operational condition (informer lag), not an engine defect."""


@dataclass
class AdmissionResponse:
    allowed: bool
    message: str = ""
    code: int = 200
    # auditAnnotations: the fail-open path allows the request but stamps
    # WHY into the audit log (admissionreview v1 auditAnnotations field),
    # so a degraded webhook leaves a forensic trail instead of silently
    # admitting
    annotations: Optional[dict] = field(default=None)

    def to_dict(self, uid: str = "") -> dict:
        out = {"uid": uid, "allowed": self.allowed}
        if self.message or not self.allowed:
            out["status"] = {"message": self.message, "code": self.code}
        if self.annotations:
            out["auditAnnotations"] = dict(self.annotations)
        return out


def _allowed(msg: str = "") -> AdmissionResponse:
    return AdmissionResponse(True, msg)


def _denied(msg: str, code: int) -> AdmissionResponse:
    return AdmissionResponse(False, msg, code)


class ValidationHandler:
    def __init__(
        self,
        client,                       # gatekeeper_tpu_torch.client.Client
        kube: Optional[InMemoryKube] = None,
        excluder: Optional[Excluder] = None,
        reporter=None,
        gk_namespace: str = "gatekeeper-system",
        log_denies: bool = False,
        emit_admission_events: bool = False,
        disable_enforcementaction_validation: bool = False,
        event_recorder: Optional[Callable[[dict], None]] = None,
        injected_config: Optional[dict] = None,
        fail_open: bool = False,
    ):
        self.client = client
        self.kube = kube
        self.excluder = excluder or Excluder()
        self.reporter = reporter
        self.gk_namespace = gk_namespace
        self.log_denies = log_denies
        self.emit_admission_events = emit_admission_events
        self.disable_enforcementaction_validation = (
            disable_enforcementaction_validation
        )
        self.event_recorder = event_recorder
        self.injected_config = injected_config
        # failure policy for internal errors and deadline exhaustion:
        # fail_open=True allows the request with an audit annotation
        # (availability over enforcement); the default denies (fail
        # closed).  Either way the decision is EXPLICIT — the caller gets
        # a well-formed AdmissionReview, never a hung socket.
        self.fail_open = fail_open
        self.service_account = (
            f"system:serviceaccount:{get_namespace()}:{SERVICE_ACCOUNT_NAME}"
        )

    # ---- entry -------------------------------------------------------------

    def handle(self, req: dict) -> AdmissionResponse:
        t0 = time.monotonic()
        # decision-log provenance (obs/decisionlog.py): the remaining
        # deadline budget at entry rides every record, and each return
        # site below lands one admission record — pre-review refusals
        # included — so a denied AdmissionReview survives the trace
        # ring's rotation
        budget_s = deadline_remaining()

        def _record(resp, hint=None, results=None):
            obsdlog.record_admission(
                req, resp, time.monotonic() - t0, budget_s=budget_s,
                results=results, hint=hint,
            )
            return resp

        if self._is_gk_service_account(req):
            return _record(_allowed("Gatekeeper does not self-manage"))

        is_delete = req.get("operation") == "DELETE"
        if is_delete:
            if req.get("oldObject") is None:
                return _record(_denied(
                    "For admission webhooks registered for DELETE operations, "
                    "please use Kubernetes v1.15.0+.",
                    500,
                ), hint=obsdlog.CLASS_ERROR)
            req = dict(req)
            req["object"] = req["oldObject"]

        # dry-run validation only gates writes; deleting a gatekeeper
        # resource must never require it to still compile/validate (an
        # orphaned constraint would otherwise be undeletable)
        if not is_delete:
            user_err, err = self._validate_gatekeeper_resources(req)
            if err is not None:
                return _record(_denied(err, 422 if user_err else 500))

        status = RESPONSE_UNKNOWN
        resp: Optional[AdmissionResponse] = None
        hint: Optional[str] = None
        results = None
        try:
            ns = req.get("namespace") or ""
            if self.excluder.is_namespace_excluded(WEBHOOK, ns):
                status = RESPONSE_ALLOW
                resp = _allowed(
                    "Namespace is set to be ignored by Gatekeeper config"
                )
                return resp
            try:
                results = self._review(req)
            except NamespaceNotSynced as e:
                # expected operational condition (namespace not yet synced,
                # policy.go:379-385): same 500 verdict, but logged without
                # the per-request traceback formatting — at admission rates
                # that costs ~0.7ms/request and is trivially attacker-paced
                log.warning("error executing query: %s", e)
                status = RESPONSE_ERROR
                hint = obsdlog.CLASS_ERROR
                resp = _denied(str(e), 500)
                return resp
            except DeadlineExceeded:
                # budget exhausted: explicit, policy-selected decision —
                # the apiserver gets a well-formed AdmissionReview inside
                # its own timeout instead of a hung socket
                log.warning("admission deadline budget exhausted")
                status = RESPONSE_ERROR
                hint = obsdlog.CLASS_EXPIRED
                resp = self._failure_response(
                    DEADLINE_MESSAGE, DEADLINE_CODE, FAIL_OPEN_DEADLINE
                )
                return resp
            except OverloadShed:
                # bounded-queue refusal (docs/failure-modes.md shed
                # order): the same explicit fail-open/closed decision,
                # answered FAST — the whole point of shedding is that
                # the refusal costs microseconds, not a queue wait
                log.warning("admission request shed under overload")
                status = RESPONSE_ERROR
                hint = obsdlog.CLASS_SHED
                resp = self._failure_response(
                    SHED_MESSAGE, SHED_CODE, FAIL_OPEN_SHED
                )
                return resp
            except Exception as e:  # error executing query -> 500
                log.exception("error executing query")
                status = RESPONSE_ERROR
                hint = obsdlog.CLASS_ERROR
                resp = self._failure_response(
                    str(e), 500, FAIL_OPEN_INTERNAL
                )
                return resp
            msgs = self._get_deny_messages(results, req)
            if msgs:
                status = RESPONSE_DENY
                resp = _denied("\n".join(msgs), 403)
                return resp
            status = RESPONSE_ALLOW
            resp = _allowed()
            return resp
        finally:
            obstrace.set_attrs(admission_status=status)
            duration_s = time.monotonic() - t0
            if resp is not None:
                # provenance record: class hint from the branch taken,
                # matched constraint set when a review completed
                obsdlog.record_admission(
                    req, resp, duration_s, budget_s=budget_s,
                    results=results, hint=hint,
                )
            # SLO event stream (obs/slo.py): the same outcome + duration
            # the request metric records, so burn rates and dashboards
            # agree by construction
            obsslo.observe_admission(status, duration_s)
            if self.reporter is not None:
                self.reporter.report_request(status, duration_s)

    def handle_many(self, items: List[tuple]) -> List[AdmissionResponse]:
        """Chunk admission for the wire listener: evaluate N
        parsed requests with ONE batcher enqueue instead of N.

        ``items`` is a list of ``(req, deadline, span)`` — deadline an
        absolute ``time.monotonic()`` instant or None, span the
        request's ``admission`` root span or None.  Returns responses
        aligned with ``items``.

        Semantics are handle()'s, request for request — same check
        order, same exception taxonomy, same decision-log records, same
        SLO stream — with the review leg routed through the client's
        submit_many/wait chunk API when it has one (the MicroBatcher),
        so the whole chunk costs one producer-lock round.  Traced
        requests and clients without submit_many fall back to the
        per-request review path."""
        n = len(items)
        out: List[Optional[AdmissionResponse]] = [None] * n
        meta = [None] * n        # (req, t0, budget_s, deadline, span)
        to_review: List[tuple] = []   # (idx, AugmentedReview, trace, dump)
        for idx, (req, deadline, span) in enumerate(items):
            t0 = time.monotonic()
            budget_s = (
                None if deadline is None else max(0.0, deadline - t0)
            )
            # --- handle()'s pre-try section: decision-log records only,
            # no SLO event (preserved asymmetry) ---
            if self._is_gk_service_account(req):
                resp = _allowed("Gatekeeper does not self-manage")
                obsdlog.record_admission(
                    req, resp, time.monotonic() - t0, budget_s=budget_s)
                out[idx] = resp
                continue
            is_delete = req.get("operation") == "DELETE"
            if is_delete:
                if req.get("oldObject") is None:
                    resp = _denied(
                        "For admission webhooks registered for DELETE "
                        "operations, please use Kubernetes v1.15.0+.",
                        500,
                    )
                    obsdlog.record_admission(
                        req, resp, time.monotonic() - t0,
                        budget_s=budget_s, hint=obsdlog.CLASS_ERROR)
                    out[idx] = resp
                    continue
                req = dict(req)
                req["object"] = req["oldObject"]
            if not is_delete:
                user_err, err = self._validate_gatekeeper_resources(req)
                if err is not None:
                    resp = _denied(err, 422 if user_err else 500)
                    obsdlog.record_admission(
                        req, resp, time.monotonic() - t0,
                        budget_s=budget_s)
                    out[idx] = resp
                    continue
            meta[idx] = (req, t0, budget_s, deadline, span)
            ns = req.get("namespace") or ""
            if self.excluder.is_namespace_excluded(WEBHOOK, ns):
                resp = _allowed(
                    "Namespace is set to be ignored by Gatekeeper config"
                )
                out[idx] = self._finalize_one(
                    req, resp, t0, budget_s, RESPONSE_ALLOW, None, None,
                    span)
                continue
            try:
                trace, dump = self._tracing_level(req)
                review = self._augmented_review(req)
            except NamespaceNotSynced as e:
                log.warning("error executing query: %s", e)
                out[idx] = self._finalize_one(
                    req, _denied(str(e), 500), t0, budget_s,
                    RESPONSE_ERROR, obsdlog.CLASS_ERROR, None, span)
                continue
            except Exception as e:
                log.exception("error executing query")
                out[idx] = self._finalize_one(
                    req, self._failure_response(str(e), 500,
                                                FAIL_OPEN_INTERNAL),
                    t0, budget_s, RESPONSE_ERROR, obsdlog.CLASS_ERROR,
                    None, span)
                continue
            to_review.append((idx, review, trace, dump))

        submit = getattr(self.client, "submit_many", None)
        waiter = getattr(self.client, "wait", None)
        batchable: List[tuple] = []
        for idx, review, trace, dump in to_review:
            if submit is None or waiter is None or trace:
                # traced requests want their own trace output (and a
                # client without the chunk API has no batch lane):
                # evaluate solo, exactly like _review
                req, t0, budget_s, deadline, span = meta[idx]
                out[idx] = self._review_one_direct(
                    req, review, trace, dump, t0, budget_s, deadline,
                    span)
            else:
                batchable.append((idx, review))
        if batchable:
            pendings = submit([
                (review, meta[idx][3], meta[idx][4])
                for idx, review in batchable
            ])
            for (idx, review), p in zip(batchable, pendings):
                req, t0, budget_s, deadline, span = meta[idx]
                results = None
                try:
                    resp_obj = waiter(p)
                    results = resp_obj.results()
                except Exception as e:
                    out[idx] = self._finalize_failure(
                        req, e, t0, budget_s, span)
                    continue
                out[idx] = self._finalize_verdict(
                    req, results, t0, budget_s, span)
        return out  # type: ignore[return-value]

    def _review_one_direct(self, req, review, trace, dump, t0, budget_s,
                           deadline, span) -> AdmissionResponse:
        """handle()'s review leg for one chunk member without the batch
        lane (traced request, or a client with no submit_many)."""
        results = None
        token = None
        try:
            if deadline is not None:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    raise DeadlineExceeded(
                        "admission deadline budget exhausted before "
                        "evaluation"
                    )
                # the wire lane has no ambient deadline (do_POST pushes
                # one on the HTTP edge): bound the batcher wait by the
                # caller's REMAINING budget or a traced request parks
                # its wire worker past the caller's deadline
                token = deadline_push(rem)
            resp_obj = self.client.review(review, tracing=trace)
            if trace:
                log.info(resp_obj.trace_dump())
            if dump:
                log.info(self.client.dump())
            results = resp_obj.results()
        except Exception as e:
            return self._finalize_failure(req, e, t0, budget_s, span)
        finally:
            if token is not None:
                deadline_pop(token)
        return self._finalize_verdict(req, results, t0, budget_s, span)

    def _finalize_failure(self, req, e, t0, budget_s,
                          span) -> AdmissionResponse:
        """handle()'s except-chain, verbatim, for the chunk path."""
        if isinstance(e, NamespaceNotSynced):
            log.warning("error executing query: %s", e)
            return self._finalize_one(
                req, _denied(str(e), 500), t0, budget_s,
                RESPONSE_ERROR, obsdlog.CLASS_ERROR, None, span)
        if isinstance(e, DeadlineExceeded):
            log.warning("admission deadline budget exhausted")
            return self._finalize_one(
                req, self._failure_response(
                    DEADLINE_MESSAGE, DEADLINE_CODE, FAIL_OPEN_DEADLINE),
                t0, budget_s, RESPONSE_ERROR, obsdlog.CLASS_EXPIRED,
                None, span)
        if isinstance(e, OverloadShed):
            log.warning("admission request shed under overload")
            return self._finalize_one(
                req, self._failure_response(
                    SHED_MESSAGE, SHED_CODE, FAIL_OPEN_SHED),
                t0, budget_s, RESPONSE_ERROR, obsdlog.CLASS_SHED,
                None, span)
        log.exception("error executing query")
        return self._finalize_one(
            req, self._failure_response(str(e), 500, FAIL_OPEN_INTERNAL),
            t0, budget_s, RESPONSE_ERROR, obsdlog.CLASS_ERROR, None, span)

    def _finalize_verdict(self, req, results, t0, budget_s,
                          span) -> AdmissionResponse:
        msgs = self._get_deny_messages(results, req)
        if msgs:
            return self._finalize_one(
                req, _denied("\n".join(msgs), 403), t0, budget_s,
                RESPONSE_DENY, None, results, span)
        return self._finalize_one(
            req, _allowed(), t0, budget_s, RESPONSE_ALLOW, None, results,
            span)

    def _finalize_one(self, req, resp, t0, budget_s, status, hint,
                      results, span) -> AdmissionResponse:
        """handle()'s finally block for one chunk member: status attr on
        the request's OWN span (the chunk path has no per-request
        CURRENT), then the identical decision-log + SLO + reporter
        triple."""
        duration_s = time.monotonic() - t0
        if span is not None:
            span.set_attrs(admission_status=status)
        obsdlog.record_admission(
            req, resp, duration_s, budget_s=budget_s, results=results,
            hint=hint,
        )
        obsslo.observe_admission(status, duration_s)
        if self.reporter is not None:
            self.reporter.report_request(status, duration_s)
        return resp

    # ---- pieces ------------------------------------------------------------

    def _failure_response(self, msg: str, code: int,
                          reason: str) -> AdmissionResponse:
        """The explicit degraded-path decision: deny (fail closed,
        default) or allow with an audit annotation recording why
        (fail open).  docs/failure-modes.md describes the ladder."""
        if self.fail_open:
            return AdmissionResponse(
                True, msg, 200,
                annotations={FAIL_OPEN_ANNOTATION: reason},
            )
        return _denied(msg, code)

    def _is_gk_service_account(self, req: dict) -> bool:
        user = (req.get("userInfo") or {}).get("username", "")
        return user == self.service_account

    def _validate_gatekeeper_resources(self, req: dict):
        """-> (user_error, error_message|None)  (policy.go:310-360)."""
        kind = req.get("kind") or {}
        group, k = kind.get("group", ""), kind.get("kind", "")
        obj = req.get("object")
        if group == TEMPLATE_GROUP and k == "ConstraintTemplate":
            try:
                self.client.create_crd(obj)
            except Exception as e:
                return True, str(e)
            return False, None
        if group == CONSTRAINT_GROUP:
            try:
                self.client.validate_constraint(obj)
            except Exception as e:
                return True, str(e)
            action = ((obj or {}).get("spec") or {}).get("enforcementAction")
            if isinstance(action, str) and action:
                if not self.disable_enforcementaction_validation:
                    try:
                        validate_enforcement_action(action)
                    except EnforcementActionError as e:
                        return False, str(e)
            return False, None
        return False, None

    def _get_config(self) -> dict:
        if self.injected_config is not None:
            return self.injected_config
        if self.kube is None:
            return {}
        try:
            return self.kube.get(CONFIG_GVK, CONFIG_NAME, self.gk_namespace)
        except NotFound:
            return {}

    def _tracing_level(self, req: dict):
        """(trace, dump) from Config.spec.validation.traces
        (policy.go:402-423)."""
        cfg = parse_config(self._get_config())
        user = (req.get("userInfo") or {}).get("username", "")
        kind = req.get("kind") or {}
        gvk = (kind.get("group", ""), kind.get("version", ""), kind.get("kind", ""))
        trace = dump = False
        for t in cfg.traces:
            if t.user != user:
                continue
            if t.kind == gvk:
                trace = True
                if t.dump.lower() == "all":
                    dump = True
        return trace, dump

    def _augmented_review(self, req: dict) -> AugmentedReview:
        req = dict(req)
        kind = req.get("kind") or {}
        # server-side-apply namespace coercion for Namespace objects
        # (policy.go:365-369, issue #792)
        if kind.get("kind") == "Namespace" and kind.get("group", "") == "":
            req["namespace"] = ""
        ns_obj = None
        ns = req.get("namespace") or ""
        if ns and self.kube is not None:
            # cached client then direct API reader (policy.go:372-385);
            # with one API abstraction both reads collapse into this get
            try:
                ns_obj = self.kube.get(("", "v1", "Namespace"), ns)
            except NotFound:
                raise NamespaceNotSynced(f"namespace {ns} not found")
        return AugmentedReview(admission_request=req, namespace=ns_obj)

    def _review(self, req: dict) -> List:
        trace, dump = self._tracing_level(req)
        review = self._augmented_review(req)
        resp = self.client.review(review, tracing=trace)
        if trace:
            log.info(resp.trace_dump())
        if dump:
            log.info(self.client.dump())
        return resp.results()

    def _get_deny_messages(self, results: List, req: dict) -> List[str]:
        msgs: List[str] = []
        resource_name = req.get("name") or ""
        if not resource_name and isinstance(req.get("object"), dict):
            resource_name = (
                (req["object"].get("metadata") or {}).get("name") or ""
            )
        kind = req.get("kind") or {}
        for r in results:
            cname = (r.constraint.get("metadata") or {}).get("name", "")
            if r.enforcement_action in (ACTION_DENY, ACTION_DRYRUN):
                kv = {
                    gklog.PROCESS: "admission",
                    gklog.EVENT_TYPE: "violation",
                    gklog.CONSTRAINT_NAME: cname,
                    gklog.CONSTRAINT_GROUP: CONSTRAINT_GROUP,
                    gklog.CONSTRAINT_API_VERSION: "v1beta1",
                    gklog.CONSTRAINT_KIND: r.constraint.get("kind", ""),
                    gklog.CONSTRAINT_ACTION: r.enforcement_action,
                    gklog.RESOURCE_GROUP: kind.get("group", ""),
                    gklog.RESOURCE_API_VERSION: kind.get("version", ""),
                    gklog.RESOURCE_KIND: kind.get("kind", ""),
                    gklog.RESOURCE_NAMESPACE: req.get("namespace", ""),
                    gklog.RESOURCE_NAME: resource_name,
                    gklog.REQUEST_USERNAME: (req.get("userInfo") or {}).get(
                        "username", ""
                    ),
                }
                if self.log_denies:
                    gklog.log_event(log, "denied admission", **kv)
                if self.emit_admission_events and self.event_recorder:
                    dryrun = r.enforcement_action == ACTION_DRYRUN
                    event_msg = (
                        "Dryrun violation"
                        if dryrun
                        else 'Admission webhook "validation.gatekeeper.sh" denied request'
                    )
                    self.event_recorder(
                        {
                            "reason": "DryrunViolation" if dryrun else "FailedAdmission",
                            "type": "Warning",
                            "message": (
                                f"{event_msg}, "
                                f"Resource Namespace: {req.get('namespace', '')}, "
                                f"Constraint: {cname}, Message: {r.msg}"
                            ),
                            "annotations": kv,
                            "namespace": self.gk_namespace,
                        }
                    )
            # only deny prompts a deny admission response (policy.go:286-288)
            if r.enforcement_action == ACTION_DENY:
                msgs.append(f"[denied by {cname}] {r.msg}")
        return msgs
