"""Stdlib HTTP front door for a webhook replica fleet (docs/fleet.md).

Production fleets sit behind a Kubernetes Service/LB; this front door
exists so the repo can drive and prove the fleet topology end to end
(bench.py fleet/chaos_fleet, tools/check_fleet_parity.py,
tools/check_self_heal.py) with nothing but the standard library.  It
forwards POST bodies (admission reviews) to one of N backends, chosen by

- ``round_robin`` — strict rotation, or
- ``least_inflight`` (default) — the backend with the fewest requests
  currently in flight, ties broken by rotation order; under mixed
  request costs this tracks per-replica service speed without any
  backend-side signal.

Wire-path observability (docs/tracing.md):

- **Trace origination.**  Every POST runs under a ``wire`` root span —
  a fresh W3C trace, or the caller's when it sent ``traceparent`` — with
  disjoint stage spans covering the full wire path: ``accept`` (request
  framing), ``read_body``, ``route_choose``, ``proxy_connect`` (connect
  + send), ``replica_wait`` (backend service time), ``write_back``.
  The stable stage set is :data:`WIRE_STAGES`;
  tools/check_observability.py cross-checks it against the docs table.
- **Downstream propagation.**  The door injects its own ``traceparent``
  on the proxied hop, so the replica's ``admission`` root adopts the
  SAME trace_id (obs/trace.py) — /debug/fleet-traces joins both halves.
- **Stage metrics.**  Every stage double-records into
  ``frontdoor_stage_seconds{stage}``; requests count into
  ``frontdoor_requests_total{outcome,backend}`` (outcome: ok /
  backend_error / no_backend / bad_request) — so stage p50s sum to the
  observed wire p50 on dashboards, not just in traces.
- **Correlation headers on EVERY response** — ``X-GK-Trace-Id`` always;
  ``X-GK-Replica`` whenever a backend was involved, explicitly
  including error/fail-static/503/502 paths (a 502's trace id is how
  the operator finds which replicas the door tried).
- ``/metrics`` serves the parent registry (wire metrics), or — with a
  :class:`~gatekeeper_tpu_torch.obs.fleetobs.MetricsFederator` attached — the
  federated fleet view; ``/debug/*`` routes through the shared
  DebugRouter (traces, stacks, profilez, and ``fleet-traces`` when a
  TraceCollector is attached).

Overload robustness (docs/failure-modes.md overload section):

- **deadline propagation** — each request's budget is ``min(the door's
  --admission-budget, the caller's X-GK-Deadline-Ms)``; backend
  connect/read timeouts clamp to the remaining budget, the REMAINING
  milliseconds ride downstream in ``X-GK-Deadline-Ms`` (the replica
  re-enters `deadline.push` with what is left, never a fresh budget),
  and expired work is dropped at door accept / before every proxy
  attempt with the explicit fail-open/closed decision.
- **bounded inflight + fast shed** — with ``max_inflight`` set, a
  request arriving while every live backend sits at its bound answers
  a single-digit-ms **429 + Retry-After** carrying the explicit
  verdict, instead of queueing into a socket (congestive collapse is
  queues, and the door refuses to build one).
- **retry budget** — the bounded single retry is additionally gated on
  a process-wide token bucket (:class:`RetryBudget`), so retries cannot
  amplify a brownout into a storm; a denied retry proceeds straight to
  the explicit 502.
- **slow-client hardening** — an inbound socket timeout bounds header
  and body reads (slowloris parks an accept thread for at most
  ``HEADER_TIMEOUT_S``) and bodies above ``MAX_BODY`` answer 413
  before the read.

Resilience (docs/failure-modes.md fleet failure matrix):

- **bounded single retry** — a request whose backend fails at the
  connection level (refused, reset, died mid-response) is retried
  exactly once, onto a *different* live backend; a second failure is an
  explicit 502 (the apiserver's failurePolicy decides — never a
  fabricated verdict, never an unbounded retry storm).
- **health-based ejection** — a connection-REFUSED backend (nothing
  listening: the replica is dead) is ejected immediately; other
  failures eject after ``EJECT_ERROR_STREAK`` consecutive errors.
  Ejected backends take no traffic.
- **probing readmission** — a background prober GETs each ejected
  backend's ``/readyz`` on a short cadence and readmits on the first
  success, so a restarted replica rejoins without operator action.
  ``/readyz`` (not ``/healthz``): a DRAINING replica keeps ``/healthz``
  at 200 by design but reports ``/readyz`` 503 — probing liveness would
  readmit a suspended backend mid-drain and route admissions into its
  503s.
- **backend swap** — ``set_backend(replica_id, host, port)`` re-points
  a named backend (the supervisor calls it after restarting a replica
  on a fresh ephemeral port) and readmits it; ``suspend(replica_id)``
  ejects administratively (the drain step of a rolling restart).

Per-backend served/error/inflight/ejected counters — plus a decaying
p50/p99 latency window per backend, so ejection decisions are
explainable without scraping traces — are exposed on ``/fleetz`` and
via :meth:`FrontDoor.stats`.
"""

from __future__ import annotations

import http.client
import itertools
import json
import logging
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple

from .. import deadline as _deadline
from .. import faults
from .. import logging as gklog
from ..metrics.catalog import (
    record_frontdoor_request,
    record_frontdoor_stage,
    record_retry_budget,
    record_retry_denied,
    record_shed,
)
from ..obs import trace as obstrace
from ..util import close_listener, join_thread

log = gklog.get("fleet.frontdoor")

ROUND_ROBIN = "round_robin"
LEAST_INFLIGHT = "least_inflight"

# headers copied through to the backend (trace context must survive the
# hop so replica traces correlate with the front-door request; the door
# then REPLACES traceparent with its own span id on the proxied hop, and
# ADDS X-GK-Deadline-Ms with the request's REMAINING budget)
_FORWARD_HEADERS = ("Content-Type", "traceparent")

# cheap uid extraction for the shed/expired fast paths: a full JSON parse
# per shed would tax exactly the path whose contract is single-digit-ms
# refusals, and the uid is the only field those responses need
_UID_RE = re.compile(rb'"uid"\s*:\s*"([^"\\]*)"')

# ---- the stable wire-path stage set (docs/tracing.md) -----------------------
# Disjoint by construction: their durations sum to the wire latency the
# client observes at the door (minus socket-level residue).  The tuple is
# the contract tools/check_observability.py checks against the docs
# table and bench.py's wire-path section reports per-stage p50/p99 over.
STAGE_ACCEPT = "accept"
STAGE_READ_BODY = "read_body"
STAGE_ROUTE_CHOOSE = "route_choose"
STAGE_PROXY_CONNECT = "proxy_connect"
STAGE_REPLICA_WAIT = "replica_wait"
STAGE_WRITE_BACK = "write_back"
WIRE_STAGES = (
    STAGE_ACCEPT, STAGE_READ_BODY, STAGE_ROUTE_CHOOSE,
    STAGE_PROXY_CONNECT, STAGE_REPLICA_WAIT, STAGE_WRITE_BACK,
)

# request outcomes for frontdoor_requests_total (docs/metrics.md)
OUTCOME_OK = "ok"
OUTCOME_BACKEND_ERROR = "backend_error"
OUTCOME_NO_BACKEND = "no_backend"
OUTCOME_BAD_REQUEST = "bad_request"
OUTCOME_SHED = "shed"          # refused by the overload plane (429)
OUTCOME_EXPIRED = "expired"    # deadline exhausted before/at the door


def _admission_review_body(uid: str, allowed: bool, message: str,
                           code: int, reason: str) -> bytes:
    """A well-formed AdmissionReview for the door's OWN refusals (shed /
    expired): the explicit fail-open/closed decision the webhook itself
    would have produced, built through the SAME AdmissionResponse
    machinery (webhook/policy.py) so door-produced and replica-produced
    verdicts cannot drift in shape.  This is NOT a fabricated
    enforcement verdict — it is the policy-selected degraded decision
    the overload contract mandates (docs/failure-modes.md)."""
    from ..webhook.policy import FAIL_OPEN_ANNOTATION, AdmissionResponse

    resp = AdmissionResponse(
        allowed, message, code,
        annotations={FAIL_OPEN_ANNOTATION: reason} if allowed else None,
    )
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1beta1",
        "kind": "AdmissionReview",
        "response": resp.to_dict(uid=uid),
    }).encode()


class RetryBudget:
    """Token-bucket retry budget: the door's bounded retry is
    additionally gated on a PROCESS-WIDE bucket, so per-request retries
    cannot multiply offered load during a brownout — the classic retry
    storm.  Refills at `rate_per_s` up to `cap`; each retry takes one
    token; an empty bucket denies the retry (the request proceeds to the
    explicit 502, it does not wait for tokens)."""

    def __init__(self, cap: float = 10.0, rate_per_s: float = 1.0):
        self.cap = float(cap)
        self.rate_per_s = float(rate_per_s)
        self._tokens = float(cap)
        self._t = time.monotonic()
        self._lock = threading.Lock()
        self.denied = 0

    def _refill_locked(self, now: float):
        self._tokens = min(
            self.cap, self._tokens + (now - self._t) * self.rate_per_s
        )
        self._t = now

    def take(self) -> bool:
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                granted = True
            else:
                self.denied += 1
                granted = False
            tokens = self._tokens
        record_retry_budget(tokens)
        if not granted:
            record_retry_denied()
        return granted

    def tokens(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            return self._tokens


class _StageClock:
    """Contiguous wire-stage stopwatch: ``mark(stage)`` closes the
    currently-open interval at *now*, records it as a stage span (under
    the active wire trace) plus a ``frontdoor_stage_seconds`` sample,
    and opens the next interval.  Adjacent by construction — stage
    durations sum to the wire duration exactly, which is the bench's
    no-dark-time criterion: every microsecond of the wire path lands in
    SOME stage, bookkeeping included, instead of leaking between
    bracketed measurements."""

    __slots__ = ("t",)

    def __init__(self, start: float):
        self.t = start

    def mark(self, stage: str, **attrs) -> float:
        now = time.perf_counter()
        obstrace.record_span("wire." + stage, self.t, now, stage=stage,
                             **attrs)
        record_frontdoor_stage(stage, now - self.t)
        self.t = now
        return now


class Backend:
    # decaying latency window (satellite: /fleetz explainability):
    # bounded samples, summarized over the trailing LATENCY_WINDOW_S
    LATENCY_SAMPLES = 1024

    __slots__ = ("host", "port", "probe_port", "replica_id", "inflight",
                 "served", "errors", "consecutive_errors", "ejected",
                 "ejected_at", "readmissions", "lock", "lat")

    def __init__(self, host: str, port: int, replica_id: str = "",
                 probe_port: int = 0):
        self.host = host
        self.port = int(port)
        # readmission probes GET /readyz over HTTP; a backend whose
        # data port speaks the wire protocol (EventFrontDoor) names the
        # replica's HTTP listener here.  0 = probe the data port.
        self.probe_port = int(probe_port)
        self.replica_id = replica_id or f"{host}:{port}"
        self.inflight = 0
        self.served = 0
        self.errors = 0
        self.consecutive_errors = 0
        self.ejected = False
        self.ejected_at = 0.0
        self.readmissions = 0
        self.lock = threading.Lock()
        self.lat: deque = deque(maxlen=self.LATENCY_SAMPLES)  # (mono, ms)

    def note_latency(self, ms: float):
        with self.lock:
            self.lat.append((time.monotonic(), ms))

    def latency_summary(self, window_s: float) -> dict:
        cutoff = time.monotonic() - window_s
        with self.lock:
            xs = sorted(ms for t, ms in self.lat if t >= cutoff)
        if not xs:
            return {"n": 0, "p50_ms": None, "p99_ms": None,
                    "window_s": window_s}
        def pct(q: float) -> float:
            return round(xs[min(int(q * len(xs)), len(xs) - 1)], 3)
        return {"n": len(xs), "p50_ms": pct(0.50), "p99_ms": pct(0.99),
                "window_s": window_s}


class FrontDoor:
    # /healthz counts a backend live until it fails this many requests
    # in a row with no success in between
    LIVE_ERROR_STREAK = 3
    # non-refused failures eject after this many consecutive errors
    # (refused connections eject immediately: nothing is listening)
    EJECT_ERROR_STREAK = 3
    # readmission probe cadence for ejected backends
    PROBE_INTERVAL_S = 0.25
    PROBE_TIMEOUT_S = 2.0
    # bounded retry: one extra attempt on a DIFFERENT backend per request
    RETRY_LIMIT = 1
    # /fleetz latency summaries decay over this trailing window
    LATENCY_WINDOW_S = 60.0
    # ---- overload plane (docs/failure-modes.md) ------------------
    # backend connect/read ceiling; the per-request deadline clamps BELOW
    # this (a 50ms-budget request never parks a socket 30s)
    BACKEND_TIMEOUT_S = 30.0
    # inbound socket timeout covering header AND body reads: a slowloris
    # client parks one accept thread for at most this long
    HEADER_TIMEOUT_S = 15.0
    # inbound body bound; admission payloads are small — larger is abuse
    MAX_BODY = 32 * 1024 * 1024
    # Retry-After advertised on shed responses (seconds)
    RETRY_AFTER_S = 1
    # retry-budget bucket defaults (RetryBudget)
    RETRY_BUDGET_CAP = 10.0
    RETRY_BUDGET_RATE_PER_S = 1.0

    def __init__(self, backends: Sequence[Tuple[str, int]] | Sequence[dict],
                 port: int = 0, policy: str = LEAST_INFLIGHT,
                 probe_interval_s: Optional[float] = None,
                 admission_budget_s: Optional[float] = None,
                 max_inflight: int = 0,
                 fail_open: bool = False,
                 retry_budget_cap: Optional[float] = None,
                 retry_budget_rate_per_s: Optional[float] = None,
                 header_timeout_s: Optional[float] = None):
        if policy not in (ROUND_ROBIN, LEAST_INFLIGHT):
            raise ValueError(f"unknown front-door policy: {policy!r}")
        self.policy = policy
        self.port = port
        self.probe_interval_s = (
            probe_interval_s if probe_interval_s is not None
            else self.PROBE_INTERVAL_S
        )
        # per-request deadline the door itself grants (min()-merged with
        # the caller's X-GK-Deadline-Ms); None = only the caller's bound
        self.admission_budget_s = admission_budget_s
        # per-backend inflight bound; 0 = unbounded (pre-overload-plane
        # behavior).  Past the bound on every live backend, the door
        # sheds with a fast 429 instead of queueing into a socket
        self.max_inflight = int(max_inflight)
        # the policy selecting the verdict on the door's OWN refusals
        # (shed / expired) — mirrors the webhook's --admission-fail-open
        self.fail_open = bool(fail_open)
        self.retry_budget = RetryBudget(
            cap=(retry_budget_cap if retry_budget_cap is not None
                 else self.RETRY_BUDGET_CAP),
            rate_per_s=(retry_budget_rate_per_s
                        if retry_budget_rate_per_s is not None
                        else self.RETRY_BUDGET_RATE_PER_S),
        )
        self.header_timeout_s = (
            header_timeout_s if header_timeout_s is not None
            else self.HEADER_TIMEOUT_S
        )
        self.sheds = 0    # door-level overload refusals (shed + expired)
        self.backends: List[Backend] = []
        for b in backends:
            if isinstance(b, dict):
                self.backends.append(Backend(
                    b.get("host", "127.0.0.1"), b["port"],
                    b.get("replica_id", ""),
                    probe_port=b.get("probe_port", 0),
                ))
            else:
                host, bport = b
                self.backends.append(Backend(host, bport))
        if not self.backends:
            raise ValueError("front door needs at least one backend")
        self._rr = itertools.count()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._local = threading.local()  # per-thread backend connections
        self._mu = threading.Lock()      # guards backend list mutation
        self._prober: Optional[threading.Thread] = None
        self._prober_stop = threading.Event()
        self.retries = 0                 # requests salvaged by the retry
        # fleet observability plane (obs/fleetobs.py): attached by the
        # harness/supervisor that knows the replica roster
        self.federator = None
        self.collector = None

    def attach_observability(self, federator=None, collector=None):
        """Wire the fleet observability plane: a
        MetricsFederator makes ``/metrics`` serve the merged fleet view;
        a TraceCollector installs ``/debug/fleet-traces`` on the shared
        router (served by this door's listener)."""
        if federator is not None:
            self.federator = federator
        if collector is not None:
            self.collector = collector.install()
        return self

    # ---- choice ----------------------------------------------------------

    def _has_capacity(self) -> bool:
        """False when EVERY live backend sits at the inflight bound —
        the door-accept fast-path shed predicate.  Advisory (lock-free
        reads): the HARD bound is _choose's per-backend reservation,
        which takes the slot under the backend's lock — this check just
        refuses the obvious case before any routing work.  With no
        bound configured, or with every backend ejected (the
        fail-static path owns that case), capacity is never the reason
        to refuse."""
        if not self.max_inflight:
            return True
        # the roster list is append-only during __init__, so lock-free
        # iteration is safe (the advisory inflight reads always were)
        live = [b for b in self.backends if not b.ejected]
        if not live:
            return True
        return any(b.inflight < self.max_inflight for b in live)

    def _choose(self, exclude: Optional[set] = None) -> Optional[Backend]:
        """Pick AND RESERVE a backend: the inflight slot is taken under
        the chosen backend's lock before this returns, so max_inflight
        holds under concurrent accepts — no check-then-act window.  The
        caller owns the reservation and must decrement inflight exactly
        once.  Raises OverloadShed when live backends exist but every
        one is at its bound (the caller answers the fast 429 — a
        saturated-but-healthy fleet must never be queued into);
        returns None only when nothing is choosable at all."""
        candidates = self.backends  # append-only after __init__; no copy
        if not exclude:
            # healthy-path fast lanes: reserve with no intermediate
            # list builds.  Fall through to the general path when
            # ejections or reservation races complicate the picture
            # (live-subset rotation fairness, fail-static probing).
            n = len(candidates)
            start = next(self._rr)
            if self.policy == ROUND_ROBIN:
                saw_ejected = False
                for k in range(n):
                    b = candidates[(start + k) % n]
                    if b.ejected:
                        saw_ejected = True
                        continue
                    with b.lock:
                        if (
                            self.max_inflight
                            and b.inflight >= self.max_inflight
                        ):
                            continue
                        b.inflight += 1
                    return b
                if not saw_ejected:
                    raise _deadline.OverloadShed(
                        "every live backend is at its inflight bound"
                    )
            else:
                # least-inflight: lock-free argmin over the rotation
                # (advisory reads, like the sort the general path
                # does), then a locked re-check on the winner only.
                # Starting the scan at the rotation point keeps ties
                # shared the way the stable sort did.
                best = None
                best_in = 0
                for k in range(n):
                    b = candidates[(start + k) % n]
                    if not b.ejected and (best is None
                                          or b.inflight < best_in):
                        best = b
                        best_in = b.inflight
                if best is not None:
                    with best.lock:
                        if not (
                            self.max_inflight
                            and best.inflight >= self.max_inflight
                        ):
                            best.inflight += 1
                            return best
                # at-bound or all-ejected: the general path below owns
                # the shed/fail-static decision
        live = [
            (i, b) for i, b in enumerate(candidates)
            if (not exclude or i not in exclude) and not b.ejected
        ]
        if live:
            start = next(self._rr) % len(live)
            rotated = live[start:] + live[:start]
            if self.policy == ROUND_ROBIN:
                ordered = rotated
            else:
                # least inflight, rotation as tiebreak (stable sort
                # over the rotated order) so equal backends share
                ordered = sorted(rotated, key=lambda ib: ib[1].inflight)
            for _i, b in ordered:
                with b.lock:
                    if (
                        self.max_inflight
                        and b.inflight >= self.max_inflight
                    ):
                        continue
                    b.inflight += 1
                return b
            raise _deadline.OverloadShed(
                "every live backend is at its inflight bound"
            )
        # every non-excluded backend is ejected: try one anyway
        # (fail-static) rather than 502ing while a backend may have
        # just come back — its success readmits it on the spot.  The
        # inflight bound deliberately does not apply here: with zero
        # live capacity the choice is between refusing everything and
        # probing the ejected set with real traffic
        fallback = [
            (i, b) for i, b in enumerate(candidates)
            if not exclude or i not in exclude
        ]
        if not fallback:
            return None
        b = fallback[next(self._rr) % len(fallback)][1]
        with b.lock:
            b.inflight += 1
        return b

    # ---- ejection / readmission ------------------------------------------

    def _eject(self, backend: Backend, why: str):
        with backend.lock:
            if backend.ejected:
                return
            backend.ejected = True
            backend.ejected_at = time.monotonic()
        # log_event: the active wire trace id (when ejection happens on
        # a request path) is injected automatically, so wire logs join
        # replica logs on trace_id
        gklog.log_event(
            log, f"backend {backend.replica_id} ejected ({why}); probing "
            "for readmission", level=logging.WARNING,
            event_type="frontdoor_eject", backend=backend.replica_id,
            reason=why,
        )

    def _readmit(self, backend: Backend, why: str):
        with backend.lock:
            if not backend.ejected:
                return
            backend.ejected = False
            backend.consecutive_errors = 0
            backend.readmissions += 1
        gklog.log_event(
            log, f"backend {backend.replica_id} readmitted ({why})",
            event_type="frontdoor_readmit", backend=backend.replica_id,
            reason=why,
        )

    def suspend(self, replica_id: str) -> bool:
        """Administrative ejection (the supervisor's drain/restart step):
        the backend takes no NEW traffic until set_backend or a probe
        readmits it.  The prober keeps running, so a suspend that was
        never followed by a swap self-heals once the replica answers."""
        b = self._find(replica_id)
        if b is None:
            return False
        self._eject(b, "suspended")
        return True

    def set_backend(self, replica_id: str, host: str, port: int) -> bool:
        """Re-point a named backend (a supervised replica restarted on a
        fresh ephemeral port) and readmit it.  Per-thread connections to
        the old port die on their next use and re-establish against the
        new one (the error path drops them)."""
        b = self._find(replica_id)
        if b is None:
            return False
        with self._mu, b.lock:
            b.host = host
            b.port = int(port)
            b.ejected = False
            b.consecutive_errors = 0
        log.info("backend %s re-pointed to %s:%d", replica_id, host, port)
        return True

    def _find(self, replica_id: str) -> Optional[Backend]:
        with self._mu:
            for b in self.backends:
                if b.replica_id == replica_id:
                    return b
        return None

    def _probe_loop(self):
        """Readmission prober: one /readyz GET per ejected backend per
        interval; the first success readmits.  Readiness, not liveness:
        a draining (or warming) replica answers /healthz 200 but /readyz
        503, and readmitting it would route admissions into its 503s.
        Daemon, stopped by stop()."""
        while not self._prober_stop.wait(self.probe_interval_s):
            with self._mu:
                ejected = [b for b in self.backends if b.ejected]
            for b in ejected:
                try:
                    conn = http.client.HTTPConnection(
                        b.host, b.probe_port or b.port,
                        timeout=self.PROBE_TIMEOUT_S,
                    )
                    conn.request("GET", "/readyz")
                    resp = conn.getresponse()
                    resp.read()
                    conn.close()
                    if resp.status == 200:
                        self._readmit(b, "readiness probe succeeded")
                except (OSError, http.client.HTTPException):
                    pass  # still down; next interval probes again

    # ---- forwarding ------------------------------------------------------

    def _conn(self, backend: Backend,
              timeout_s: Optional[float] = None
              ) -> http.client.HTTPConnection:
        """Per-thread persistent connection, its connect/read timeout
        clamped to the REQUEST's remaining deadline (never the flat
        ceiling): an expired request must surface as an explicit
        decision at the caller, not a socket parked for 30s holding a
        backend slot."""
        timeout_s = (
            self.BACKEND_TIMEOUT_S if timeout_s is None
            else max(min(timeout_s, self.BACKEND_TIMEOUT_S), 1e-3)
        )
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        key = (backend.host, backend.port)
        conn = conns.get(key)
        if conn is None:
            conn = http.client.HTTPConnection(
                backend.host, backend.port, timeout=timeout_s
            )
            conns[key] = conn
        else:
            conn.timeout = timeout_s  # applies on (re)connect
            if conn.sock is not None:
                conn.sock.settimeout(timeout_s)  # applies to live reads
        return conn

    def _drop_conn(self, backend: Backend):
        conns = getattr(self._local, "conns", None)
        if conns is not None:
            conn = conns.pop((backend.host, backend.port), None)
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass  # dropping a dead connection; close is best-effort

    def forward(self, method: str, path: str, body: bytes,
                headers: dict,
                clock: Optional[_StageClock] = None
                ) -> Tuple[int, dict, bytes, str]:
        """-> (status, response_headers, body, replica_id).  One attempt
        plus at most RETRY_LIMIT retries, each on a DIFFERENT backend;
        raises ConnectionError when they all fail (the caller answers
        502 — never a silent allow).

        Deadline discipline: each attempt starts by checking
        the request's remaining budget (the contextvar the door's POST
        handler pushed) — an expired request raises DeadlineExceeded
        (the caller answers the explicit expired decision, it never
        dangles a socket); the backend connect/read timeout is clamped
        to the remaining budget; and the REMAINING milliseconds ride
        downstream in the X-GK-Deadline-Ms header, so the replica
        re-enters its own deadline with what is actually left.

        Retries are gated on the process-wide token-bucket retry budget
        (self.retry_budget): under a brownout, spent tokens turn would-be
        retries into the explicit 502 instead of doubling offered load.

        Stage marks per attempt on the contiguous clock:
        ``route_choose`` (backend selection), ``proxy_connect``
        (connection + request send, where the door's own ``traceparent``
        is injected downstream), ``replica_wait`` (response wait +
        read); a failed attempt closes whichever stage was in flight.
        The last tried backend's id is left in
        ``self._local.last_backend`` so even a 502 names who was asked."""
        if clock is None:
            clock = _StageClock(time.perf_counter())
        tried: set = set()
        last_exc: Optional[Exception] = None
        self._local.last_backend = ""
        attempt = 0
        while attempt <= self.RETRY_LIMIT:
            remaining_s = _deadline.remaining()
            if remaining_s is not None and remaining_s <= 0:
                # expired between stages (or during a failed attempt):
                # drop the work HERE — a proxied dispatch the caller can
                # no longer use is pure wasted backend time
                raise _deadline.DeadlineExceeded(
                    "request deadline exhausted at the front door"
                )
            backend = self._choose(exclude=tried)  # reserves the slot
            if backend is None:
                break
            with self._mu:
                try:
                    idx = self.backends.index(backend)
                except ValueError:
                    # raced a backend-list mutation; release the
                    # reservation _choose took and re-choose — NOT an
                    # attempt (no backend was tried) and no retry token
                    with backend.lock:
                        backend.inflight -= 1
                    continue
            if attempt > 0 and not self.retry_budget.take():
                # the bounded retry exists, but a brownout must not be
                # amplified by it: no token, no retry — the explicit
                # 502 path answers (the apiserver's failurePolicy
                # decides, exactly as when the retry itself fails).
                # Taken only AFTER a backend is secured, so a dead-end
                # choose never burns a token; the reservation is
                # released since this backend will not be tried
                with backend.lock:
                    backend.inflight -= 1
                gklog.log_event(
                    log, "front-door retry denied: retry budget empty",
                    level=logging.WARNING,
                    event_type="frontdoor_retry_denied",
                )
                break
            tried.add(idx)
            self._local.last_backend = backend.replica_id
            t_attempt = clock.mark(STAGE_ROUTE_CHOOSE, attempt=attempt)
            pending = STAGE_PROXY_CONNECT
            try:
                if faults.ENABLED:
                    # the overload-storm seam: a latency rule here models
                    # a slow replica hop with the inflight slot HELD
                    # (which is what drives the accept-time shed in chaos
                    # tests); an error rule is a failing backend and
                    # follows the ordinary error/eject path below
                    faults.fire(faults.OVERLOAD_STORM)
                conn = self._conn(backend, remaining_s)
                hdrs = dict(headers)
                # the door's OWN trace context on the proxied hop: the
                # replica's admission root adopts this trace_id and
                # records this span as its remote parent, which is what
                # /debug/fleet-traces joins on
                cur = obstrace.current_span()
                if cur is not None:
                    hdrs["traceparent"] = obstrace.format_traceparent(
                        cur.trace.trace_id, cur.span_id
                    )
                # remaining wire budget downstream, recomputed at send
                # time: the replica must see what is LEFT, not what the
                # caller started with
                rem_ms = _deadline.remaining_ms()
                if rem_ms is not None:
                    hdrs[_deadline.DEADLINE_HEADER] = (
                        f"{max(rem_ms, 0.0):.1f}"
                    )
                conn.request(method, path, body=body, headers=hdrs)
                clock.mark(STAGE_PROXY_CONNECT,
                           backend=backend.replica_id)
                pending = STAGE_REPLICA_WAIT
                resp = conn.getresponse()
                data = resp.read()
                clock.mark(STAGE_REPLICA_WAIT,
                           backend=backend.replica_id)
                pending = None
                backend.note_latency((clock.t - t_attempt) * 1e3)
                with backend.lock:
                    backend.inflight -= 1
                    backend.served += 1
                    backend.consecutive_errors = 0
                if backend.ejected and resp.status != 503:
                    # the fail-static path above proved it live again
                    # (a 503 is a draining/not-ready replica answering
                    # honestly — it must NOT re-enter rotation)
                    self._readmit(backend, "served while ejected")
                if attempt > 0:
                    self.retries += 1
                return resp.status, dict(resp.getheaders()), data, \
                    backend.replica_id
            except Exception as e:
                last_exc = e
                if pending:
                    # close the in-flight stage: the failed attempt's
                    # time was real and must not become dark time
                    clock.mark(pending, backend=backend.replica_id,
                               error=type(e).__name__)
                self._drop_conn(backend)
                rem_after = _deadline.remaining()
                deadline_induced = (
                    isinstance(e, TimeoutError)
                    and rem_after is not None and rem_after <= 0
                )
                with backend.lock:
                    backend.inflight -= 1
                    # a deadline-induced timeout still CHARGES the
                    # streak: one tight-budget expiry is forgiven by the
                    # next success, but a backend that times out every
                    # request in a row is indistinguishable from wedged
                    # and must eject like any other failure — the
                    # /readyz prober readmits a healthy one within a
                    # probe interval, while never ejecting would leave
                    # a wedged replica burning budgets forever
                    backend.errors += 1
                    backend.consecutive_errors += 1
                    streak = backend.consecutive_errors
                if deadline_induced:
                    if streak >= self.EJECT_ERROR_STREAK:
                        self._eject(backend, f"{streak} consecutive "
                                    "errors (deadline-clamped timeouts)")
                    # the REQUEST is out of time either way: surface the
                    # explicit expired decision, never a retry it cannot
                    # use
                    raise _deadline.DeadlineExceeded(
                        "request deadline exhausted waiting on "
                        f"{backend.replica_id}"
                    )
                if isinstance(e, ConnectionRefusedError):
                    # nothing listening: the replica is DEAD, not slow —
                    # eject now, don't tax the next streak's requests
                    self._eject(backend, "connection refused")
                elif streak >= self.EJECT_ERROR_STREAK:
                    self._eject(backend, f"{streak} consecutive errors")
                gklog.log_event(
                    log,
                    f"backend {backend.replica_id} failed "
                    f"({type(e).__name__}: {e}); "
                    + ("retrying on a different backend"
                       if attempt < self.RETRY_LIMIT
                       else "retry budget spent"),
                    level=logging.WARNING,
                    event_type="frontdoor_backend_error",
                    backend=backend.replica_id, attempt=attempt,
                )
                attempt += 1  # only real tried-a-backend failures count
        raise ConnectionError(
            f"no fleet backend answered: {last_exc!r}"
        )

    # ---- stats -----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "policy": self.policy,
            "retries": self.retries,
            "sheds": self.sheds,
            "max_inflight": self.max_inflight,
            "admission_budget_ms": (
                round(self.admission_budget_s * 1e3, 3)
                if self.admission_budget_s is not None else None
            ),
            "retry_budget": {
                "tokens": round(self.retry_budget.tokens(), 3),
                "cap": self.retry_budget.cap,
                "rate_per_s": self.retry_budget.rate_per_s,
                "denied": self.retry_budget.denied,
            },
            "backends": [
                {
                    "replica_id": b.replica_id,
                    "host": b.host, "port": b.port,
                    "inflight": b.inflight,
                    "served": b.served,
                    "errors": b.errors,
                    "consecutive_errors": b.consecutive_errors,
                    "ejected": b.ejected,
                    "readmissions": b.readmissions,
                    "latency": b.latency_summary(self.LATENCY_WINDOW_S),
                }
                for b in self.backends
            ],
        }

    # ---- server ----------------------------------------------------------

    def start(self):
        # idempotent, like every other listener in this repo (a double
        # start replaces, never leaks)
        close_listener(self._server, self._thread)
        self._server = None
        self._thread = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True
            # slow-client hardening: socketserver applies
            # this to the connection, so header reads AND body reads are
            # bounded — a slowloris peer parks an accept thread for at
            # most this long, then the connection closes
            timeout = outer.header_timeout_s

            def log_message(self, *args):
                pass

            def parse_request(self):
                # the accept-stage anchor: request line is buffered, the
                # headers are about to be read/parsed — the earliest
                # per-request point this handler can observe
                self._t_accept = time.perf_counter()
                return super().parse_request()

            def _send(self, code: int, ctype: str, body: bytes,
                      replica: str = "", trace_id: str = "",
                      retry_after: bool = False):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                # correlation on EVERY response, error paths included:
                # the trace id is how a 502 is matched to its
                # /debug/fleet-traces entry and the replica logs
                if replica:
                    self.send_header("X-GK-Replica", replica)
                if trace_id:
                    self.send_header("X-GK-Trace-Id", trace_id)
                if retry_after:
                    # shed contract: the caller is told WHEN to come
                    # back, so well-behaved clients pace themselves
                    self.send_header("Retry-After",
                                     str(outer.RETRY_AFTER_S))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    # liveness must be RECENT: a backend that once
                    # served but now fails every request is dead, so
                    # the predicate is ejection + the current error
                    # streak, not a sticky served counter
                    live = sum(
                        1 for b in outer.backends
                        if not b.ejected
                        and b.consecutive_errors < outer.LIVE_ERROR_STREAK
                    )
                    self._send(200 if live else 503, "text/plain",
                               b"ok" if live else b"no backends")
                elif path == "/fleetz":
                    self._send(200, "application/json",
                               json.dumps(outer.stats()).encode())
                elif path == "/metrics":
                    self._metrics()
                elif path.startswith("/debug/"):
                    from ..obs.debug import get_router

                    self._send(*get_router().handle(path, query))
                else:
                    self._send(404, "text/plain", b"not found")

            def _metrics(self):
                from ..metrics.exporter import (
                    CONTENT_TYPE_TEXT,
                    render_prometheus,
                )

                fed = outer.federator
                body = (fed.render() if fed is not None
                        else render_prometheus())
                self._send(200, CONTENT_TYPE_TEXT, body.encode())

            def _refuse(self, wsp, clock, tid: str, body: bytes,
                        expired: bool):
                """The door's own fast refusal: an expired
                deadline answers the explicit fail-open/closed decision
                the webhook would have produced (HTTP 200, code 504 in
                the verdict); an overload shed answers 429 +
                Retry-After with the same explicit verdict in the body.
                Both are single-digit-ms paths by construction: no
                routing, no proxying, one regex for the uid."""
                from ..webhook.policy import (
                    DEADLINE_CODE,
                    DEADLINE_MESSAGE,
                    FAIL_OPEN_DEADLINE,
                    FAIL_OPEN_SHED,
                    SHED_CODE,
                    SHED_MESSAGE,
                )

                m = _UID_RE.search(body or b"")
                uid = m.group(1).decode("utf-8", "replace") if m else ""
                if expired:
                    outcome, reason = OUTCOME_EXPIRED, "deadline_expired"
                    msg, code, annot = (
                        DEADLINE_MESSAGE, DEADLINE_CODE, FAIL_OPEN_DEADLINE
                    )
                    http_code, retry_after = 200, False
                else:
                    outcome, reason = OUTCOME_SHED, "door_inflight"
                    msg, code, annot = (
                        SHED_MESSAGE, SHED_CODE, FAIL_OPEN_SHED
                    )
                    http_code, retry_after = 429, True
                with outer._mu:  # += on many handler threads loses updates
                    outer.sheds += 1
                wsp.set_attrs(outcome=outcome, shed_reason=reason)
                record_frontdoor_request(outcome, "")
                record_shed(reason)
                payload = _admission_review_body(
                    uid, outer.fail_open, msg, code, annot
                )
                self._send(http_code, "application/json", payload,
                           trace_id=tid, retry_after=retry_after)
                clock.mark(STAGE_WRITE_BACK)

            def do_POST(self):
                t_accept = getattr(self, "_t_accept", None)
                if t_accept is None:
                    t_accept = time.perf_counter()
                # the wire trace: originated here (or adopted from the
                # caller's traceparent), stage spans land in the parent
                # tracer's ring for /debug/traces + /debug/fleet-traces
                with obstrace.root_span(
                    "wire",
                    traceparent=self.headers.get("traceparent"),
                    start=t_accept,
                    path=self.path,
                ) as wsp:
                    tid = wsp.trace.trace_id
                    clock = _StageClock(t_accept)
                    clock.mark(STAGE_ACCEPT)
                    try:
                        length = int(
                            self.headers.get("Content-Length", 0))
                    except (TypeError, ValueError):
                        self.close_connection = True
                        wsp.set_attrs(outcome=OUTCOME_BAD_REQUEST)
                        record_frontdoor_request(OUTCOME_BAD_REQUEST, "")
                        self._send(400, "text/plain",
                                   b"bad Content-Length", trace_id=tid)
                        clock.mark(STAGE_WRITE_BACK)
                        return
                    if length > outer.MAX_BODY:
                        # bounded inbound body: an admission review this
                        # large is abuse or corruption; refusing before
                        # the read keeps the accept thread free
                        self.close_connection = True
                        wsp.set_attrs(outcome=OUTCOME_BAD_REQUEST)
                        record_frontdoor_request(OUTCOME_BAD_REQUEST, "")
                        self._send(413, "text/plain", b"body too large",
                                   trace_id=tid)
                        clock.mark(STAGE_WRITE_BACK)
                        return
                    if faults.ENABLED:
                        # the slow-client seam: a latency rule holds an
                        # accept thread through read_body, the slowloris
                        # shape the socket timeout bounds in production
                        faults.fire(faults.SLOW_CLIENT)
                    try:
                        body = (self.rfile.read(length)
                                if length > 0 else b"")
                    except TimeoutError:
                        # slowloris body: the inbound socket timeout
                        # fired mid-read — close, don't park forever
                        self.close_connection = True
                        wsp.set_attrs(outcome=OUTCOME_BAD_REQUEST)
                        record_frontdoor_request(OUTCOME_BAD_REQUEST, "")
                        self._send(408, "text/plain",
                                   b"request body timeout", trace_id=tid)
                        clock.mark(STAGE_WRITE_BACK)
                        return
                    fwd = {
                        k: v for k in _FORWARD_HEADERS
                        if (v := self.headers.get(k)) is not None
                    }
                    fwd["Content-Length"] = str(len(body))
                    clock.mark(STAGE_READ_BODY)
                    # the request's end-to-end deadline: min(the door's
                    # own admission budget, the caller's remaining wire
                    # budget).  Pushed on the contextvar so forward()
                    # clamps socket timeouts to it and re-exports the
                    # REMAINING milliseconds downstream
                    budget = _deadline.effective_budget_s(
                        outer.admission_budget_s,
                        _deadline.parse_header_ms(
                            self.headers.get(_deadline.DEADLINE_HEADER)
                        ),
                    )
                    token = (
                        _deadline.push(budget) if budget is not None
                        else None
                    )
                    try:
                        if budget is not None and budget <= 0:
                            # dead on arrival: drop at door accept
                            self._refuse(wsp, clock, tid, body,
                                         expired=True)
                            return
                        if not outer._has_capacity():
                            # every live backend at its inflight bound:
                            # fast 429 + Retry-After instead of queueing
                            # the request into a socket
                            self._refuse(wsp, clock, tid, body,
                                         expired=False)
                            return
                        try:
                            code, _hdrs, data, rid = outer.forward(
                                "POST", self.path, body, fwd, clock=clock
                            )
                        except _deadline.DeadlineExceeded:
                            self._refuse(wsp, clock, tid, body,
                                         expired=True)
                            return
                        except _deadline.OverloadShed:
                            # _choose found live backends but every one
                            # at its bound (slots filled between the
                            # accept-time check and routing): the same
                            # fast 429, just decided one stage later
                            self._refuse(wsp, clock, tid, body,
                                         expired=False)
                            return
                        except ConnectionError as e:
                            # all backends down: explicit 502, the
                            # apiserver's failurePolicy decides — never a
                            # fabricated verdict.  The last TRIED backend
                            # is still named: a 502 without a suspect is
                            # unactionable
                            rid = getattr(outer._local, "last_backend", "")
                            wsp.set_attrs(outcome=OUTCOME_NO_BACKEND,
                                          backend=rid)
                            record_frontdoor_request(OUTCOME_NO_BACKEND,
                                                     rid)
                            gklog.log_event(
                                log, "front door exhausted its backends",
                                level=logging.WARNING,
                                event_type="frontdoor_no_backend",
                                last_backend=rid,
                            )
                            self._send(502, "text/plain",
                                       str(e).encode(),
                                       replica=rid, trace_id=tid)
                            clock.mark(STAGE_WRITE_BACK)
                            return
                        outcome = (OUTCOME_OK if 200 <= code < 300
                                   else OUTCOME_BACKEND_ERROR)
                        wsp.set_attrs(outcome=outcome, backend=rid,
                                      status=code)
                        record_frontdoor_request(outcome, rid)
                        self._send(code, "application/json", data,
                                   replica=rid, trace_id=tid)
                        clock.mark(STAGE_WRITE_BACK)
                    finally:
                        if token is not None:
                            _deadline.pop(token)

        # the listen backlog of EventFrontDoor's and the wire listener's
        # sockets: socketserver's default of 5 overflows under a burst of
        # new connections, the kernel drops their SYNs, and each client
        # waits the 1 s SYN retransmission before its request (a 429
        # shed then took ~1.03 s at the client)
        server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler,
                                     bind_and_activate=False)
        server.request_queue_size = 1024
        try:
            server.server_bind()
            server.server_activate()
        except BaseException:
            server.server_close()
            raise
        self._server = server
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="frontdoor", daemon=True
        )
        self._thread.start()
        self._prober_stop.clear()
        self._prober = threading.Thread(
            target=self._probe_loop, name="frontdoor-probe", daemon=True
        )
        self._prober.start()
        return self

    def stop(self):
        self._prober_stop.set()
        if self._prober is not None:
            join_thread(self._prober, 5.0, "front-door prober")
            self._prober = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None
