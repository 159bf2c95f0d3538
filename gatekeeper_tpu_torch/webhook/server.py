"""Webhook HTTPS front end with TPU micro-batching.

The reference serves /v1/admit and /v1/admitlabel from controller-runtime's
webhook server (pkg/webhook/webhook.go:36-43, main.go:145).  Here the server
is a threaded HTTP(S) listener whose admission path goes through a
`MicroBatcher`: concurrent requests inside a short window coalesce into ONE
batched device dispatch (TpuDriver.review_batch), which is how p99 stays low
while the TPU runs at batch efficiency (SURVEY.md §7 stage 5).
"""

from __future__ import annotations

import json
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from .. import deadline as _deadline
from .. import faults
from .. import logging as gklog
from ..metrics.catalog import (
    WEBHOOK_QUEUE_M,
    record_batch_size,
    record_batcher_state,
    record_shed,
    record_stage,
)
from ..obs import trace as obstrace
from ..util import join_thread
from ..obs.debug import get_router
from .namespacelabel import NamespaceLabelHandler
from .policy import AdmissionResponse, ValidationHandler

log = gklog.get("webhook.server")

# paths that never produce an access log line (scrape/probe traffic —
# the /metrics convention extended to the debug surface)
QUIET_PATHS = ("/healthz", "/readyz", "/statusz", "/metrics")
DEBUG_PREFIX = "/debug/"


class BatcherStopped(RuntimeError):
    """Raised to requests enqueued on (or pending across) a stopped
    MicroBatcher — they must fail fast, not wait on an event forever."""


def _low_value(obj) -> bool:
    """Shed-priority classification (docs/failure-modes.md shed order):
    dry-run admissions are advisory — under overload they are refused
    before any enforced admission is.  Accepts both the handler's
    AugmentedReview and a bare request dict (tests, embedders)."""
    req = getattr(obj, "admission_request", None)
    if req is None and isinstance(obj, dict):
        req = obj
    return bool(isinstance(req, dict) and req.get("dryRun"))


_SPAN_CURRENT = object()  # _Pending sentinel: adopt the caller's span


class _Pending:
    __slots__ = (
        "obj", "event", "result", "error", "deadline", "low_value",
        "span", "queue_span",
    )

    def __init__(self, obj, deadline: Optional[float] = None,
                 span=_SPAN_CURRENT):
        self.obj = obj
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        self.deadline = deadline  # absolute monotonic, or None
        self.low_value = _low_value(obj)
        # explicit cross-thread context passing: the request's active span
        # (linked by the batch span) and its open queue-wait span (ended
        # by the batch thread when the batch is drained).  The wire
        # listener's chunk path has no per-request thread, so it passes
        # each request's span explicitly instead of relying on CURRENT.
        if span is _SPAN_CURRENT:
            span = obstrace.current_span()
        self.span = span
        self.queue_span = (
            obstrace.detached_span(
                "webhook.queue_wait", parent=self.span,
                stage=obstrace.QUEUE_WAIT,
            )
            if self.span is not None else None
        )


class MicroBatcher:
    """Client-compatible wrapper that coalesces concurrent review() calls.

    Continuous batching: when the system is idle, a request dispatches
    immediately (zero added latency — the sparse-traffic p99 must not pay
    the window).  During a burst — detected as arrivals landing hot on the
    heels of the previous dispatch — the thread holds the window open for
    up to `window_s` so concurrent arrivals share one review_batch; and
    while a batch is evaluating, new arrivals accumulate naturally behind
    it, which is the real batching mechanism under sustained load.

    LOAD-ADAPTIVE (docs/fleet.md): with a routing calibration on the
    driver (TpuDriver.calibrate_routing — rtt/cells-per-ms, the
    BENCH_r04/r05 `routing_calibration` model), the batcher continuously
    adapts to the offered load it observes:

    - it tracks a decayed arrival rate λ (reviews/s);
    - the TARGET batch size is the batching equilibrium B = λ·T(B),
      where T(B) is the model-predicted service time of a B-review
      batch on its cheapest tier — low load fixes the target at 1
      (immediate flush, the inline fast path keeps the p99 floor), high
      load grows batches toward the throughput-optimal tier;
    - the FLUSH DEADLINE is the time it takes λ to deliver the target
      (capped by ``max_deadline_s``), so a lull never strands a partial
      batch;
    - λ is pushed to the driver (set_offered_load) each dispatch, which
      makes the interp/np/device route choice load-aware instead of
      size-only.

    Without a calibration the adaptive controller stays dormant and the
    original recent-concurrency window heuristic applies unchanged.
    """

    # adaptation cadence/shape knobs (class-level so tests can tune)
    RATE_BUCKET_S = 0.25     # arrival-rate sampling bucket
    RATE_ALPHA = 0.5         # EWMA blend per bucket
    IDLE_RESET_S = 2.0       # no arrivals this long -> rate resets to 0
    # dispatch headroom reserved when the adaptive window is clamped to
    # a queued member's admission-deadline budget
    DEADLINE_CLAMP_MARGIN_S = 0.002
    # bounded backpressure (docs/failure-modes.md): the pending
    # queue never grows past this — past the bound, the lowest-value work
    # (dry-run admissions) sheds first, then new arrivals shed outright.
    # 0 = unbounded (the pre-overload-plane behavior, tests only).
    MAX_PENDING = 1024

    def __init__(self, client, window_s: float = 0.002, max_batch: int = 256,
                 adaptive: bool = True, max_deadline_s: float = 0.025,
                 max_pending: Optional[int] = None):
        self._client = client
        self.window_s = window_s
        self.max_batch = max_batch
        self.adaptive = adaptive
        self.max_deadline_s = max_deadline_s
        self.max_pending = (
            self.MAX_PENDING if max_pending is None else int(max_pending)
        )
        self.sheds = 0  # queue-bound refusals (brownout signal + /statusz)
        self._pending: List[_Pending] = []
        # queued dry-run count (maintained under the cv): the at-bound
        # eviction scan short-circuits to O(1) when no dry-run is
        # queued — the common case under an all-enforced storm, which
        # is exactly when the enqueue path is hottest
        self._pending_dryruns = 0
        self._cv = threading.Condition()
        self._inline = threading.Lock()  # at most one idle fast-path eval
        self._busy = False  # a batch is evaluating (pending already drained)
        self._stop = False
        # arrival-rate tracking (its own tiny lock: the inline fast path
        # must not contend on _cv just to count itself)
        self._rate_lock = threading.Lock()
        self._arrivals = 0
        self._rate_t0 = time.monotonic()
        self._load_rps = 0.0
        # current adaptation state (read by tests, /debug spans, metrics)
        self._target_batch = 1
        self._deadline_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name="microbatcher", daemon=True
        )
        self._thread.start()

    # anything that isn't review() passes straight through to the client
    def __getattr__(self, name):
        return getattr(self._client, name)

    # ---- load-adaptive controller ---------------------------------------

    def _note_arrival(self):
        with self._rate_lock:
            self._arrivals += 1

    def offered_load_rps(self) -> float:
        """Decayed arrival rate (reviews/s); rolls the sampling bucket as
        a side effect.  An empty bucket decays the EWMA toward zero, so
        a burst minutes ago never taxes today's lone request."""
        now = time.monotonic()
        with self._rate_lock:
            dt = now - self._rate_t0
            if dt >= self.RATE_BUCKET_S:
                inst = self._arrivals / dt
                if dt >= self.IDLE_RESET_S:
                    # the bucket only rolls when _adapt runs, so a long
                    # gap means the batcher sat idle: adopt the gap's
                    # observed (near-zero) rate outright — one EWMA
                    # blend would leave half of a minutes-old burst
                    # taxing today's lone request with a deadline
                    self._load_rps = inst
                else:
                    self._load_rps = (
                        inst if self._load_rps == 0.0
                        else (1.0 - self.RATE_ALPHA) * self._load_rps
                        + self.RATE_ALPHA * inst
                    )
                if self._load_rps < 1e-3:
                    self._load_rps = 0.0
                self._arrivals = 0
                self._rate_t0 = now
            return self._load_rps

    def _service_model(self):
        """(predict, set_load) from the wrapped client's driver — None
        pair when there is no calibrated TpuDriver underneath (tests,
        interp deployments): the adaptive controller then stays dormant
        and the static recent-concurrency heuristic applies."""
        drv = getattr(self._client, "driver", None)
        target = drv if drv is not None else self._client
        return (
            getattr(target, "predicted_batch_ms", None),
            getattr(target, "set_offered_load", None),
        )

    def _adapt(self):
        """(target_batch, deadline_s) for the next accumulation window.

        Target is the batching equilibrium B = λ·T(B) under the driver's
        calibrated service model T (fixed-point iterated, clamped to
        [1, max_batch]): while one batch evaluates, λ·T(B) new arrivals
        accumulate behind it, so dispatching exactly that many keeps the
        queue stationary.  The deadline is the time λ needs to deliver
        the target (capped), so a lull flushes a partial batch instead
        of stranding it.  Low load collapses to (1, 0) — immediate
        dispatch, the inline fast path keeps the sparse-traffic p99.
        Pushes λ to the driver so routing is load-aware, and exports the
        webhook_batch_* gauges."""
        lam = self.offered_load_rps()
        target, deadline = 1, 0.0
        predict, set_load = self._service_model()
        if self.adaptive and lam > 0.0 and predict is not None:
            try:
                if set_load is not None:
                    set_load(lam)
                lam_pms = lam / 1e3
                b = 1.0
                t_ms = None
                for _ in range(4):  # fixed point; converges in 2-3 steps
                    t_ms = predict(max(int(b), 1))
                    if t_ms is None:
                        break
                    nb = min(max(lam_pms * t_ms, 1.0),
                             float(self.max_batch))
                    if abs(nb - b) < 0.5:
                        b = nb
                        break
                    b = nb
                if t_ms is not None:
                    target = max(int(round(b)), 1)
                    if target > 1:
                        deadline = min(target / lam, self.max_deadline_s)
            except Exception:  # the model must never stall dispatch
                target, deadline = 1, 0.0
        self._target_batch, self._deadline_s = target, deadline
        record_batcher_state(target, deadline * 1e3, lam)
        return target, deadline

    def review(self, obj, tracing: bool = False):
        if faults.ENABLED:
            faults.fire(faults.WEBHOOK_ENQUEUE)
        self._note_arrival()
        if tracing:
            # traced requests are rare and want their own trace output;
            # bypass the batch
            return self._client.review(obj, tracing=True)
        dl = _deadline.current()
        if dl is not None and time.monotonic() > dl:
            # refuse to enqueue work that can no longer finish in budget
            raise _deadline.DeadlineExceeded(
                "admission deadline budget exhausted before evaluation"
            )
        # idle fast path: with nothing else in flight, evaluate on the
        # caller's thread — two scheduler handoffs per request otherwise
        # put milliseconds of wakeup jitter into the sparse-traffic p99.
        # The lock bounds inline evaluation to one caller; arrivals during
        # an in-flight batch (_busy) queue instead, so they join the next
        # coalesced dispatch rather than blocking solo on the driver lock.
        # Deadline-carrying requests always queue: an inline evaluation on
        # the caller's thread cannot be interrupted, so a wedged backend
        # would hold the request past any budget — the queued path's
        # event wait is what bounds time-to-answer (docs/failure-modes.md).
        if (
            dl is None
            and not self._stop  # stopped batcher: fall through and reject
            and not self._pending
            and not self._busy
            and self._inline.acquire(blocking=False)
        ):
            try:
                if not self._pending and not self._busy and not self._stop:
                    return self._client.review(obj)
            finally:
                self._inline.release()
        p = _Pending(obj, deadline=dl)
        # bounded backpressure (docs/failure-modes.md shed order): the
        # decision is made under the cv, but refusals are DELIVERED (and
        # counted) outside it — Event.set on an evicted waiter and the
        # registry record must not run under the producer lock
        evicted: Optional[_Pending] = None
        shed_self = False
        with self._cv:
            if self._stop:
                # enqueues after stop() must fail fast, never wait on an
                # event no batch loop will ever set
                raise BatcherStopped("webhook batcher is stopped")
            if self.max_pending and len(self._pending) >= self.max_pending:
                if p.low_value:
                    # a dry-run arrival at the bound sheds itself: it is
                    # the lowest-value work in sight
                    shed_self = True
                elif self._pending_dryruns > 0:
                    # an enforced admission preempts the oldest QUEUED
                    # dry-run (the counter makes the no-dry-run case
                    # O(1) — no scan under the cv at peak load)
                    for i, q in enumerate(self._pending):
                        if q.low_value:
                            evicted = self._pending.pop(i)
                            self._pending_dryruns -= 1
                            break
                    if evicted is None:
                        shed_self = True
                else:
                    # nothing to preempt — the bound is the bound
                    shed_self = True
            if not shed_self:
                self._pending.append(p)
                if p.low_value:
                    self._pending_dryruns += 1
                self._cv.notify()
        if evicted is not None:
            with self._rate_lock:  # += races concurrent shedders
                self.sheds += 1
            if evicted.queue_span is not None:
                evicted.queue_span.end()
            evicted.error = _deadline.OverloadShed(
                "dry-run admission preempted by enforced work at the "
                "pending bound"
            )
            evicted.event.set()
            record_shed("queue_full_dryrun")
        if shed_self:
            with self._rate_lock:  # += races concurrent shedders
                self.sheds += 1
            if p.queue_span is not None:
                # the span opened at _Pending construction must close
                # even though the request never queued — shed traces
                # otherwise lose their (zero-length) queue_wait stage
                p.queue_span.end()
            record_shed(
                "queue_full_dryrun" if p.low_value else "queue_full"
            )
            raise _deadline.OverloadShed(
                "micro-batcher pending queue is at its bound "
                f"({self.max_pending})"
            )
        if dl is None:
            p.event.wait()
        elif not p.event.wait(timeout=max(0.0, dl - time.monotonic())):
            raise _deadline.DeadlineExceeded(
                "admission deadline budget exhausted"
            )
        if p.error is not None:
            raise p.error
        return p.result

    def submit_many(self, items):
        """Chunk enqueue: admit a whole decoded wire chunk
        under ONE cv acquisition — the point of the batched door↔replica
        protocol is that N pipelined requests cost one producer-lock
        round and one notify, not N.

        ``items`` is an iterable of ``(obj, deadline, span)`` — deadline
        an absolute monotonic instant or None, span the request's root
        span or None (the chunk path has no per-request thread, so
        CURRENT would be wrong).  Returns the list of `_Pending`s, every
        one of which WILL complete: refusals — stopped batcher, expired
        budget, queue bound — are delivered as ``p.error`` instead of
        raised, so the caller finalizes all requests of a chunk through
        the same :meth:`wait` tail.  Shed accounting (self.sheds,
        record_shed, dry-run-first eviction) matches review() exactly:
        the overload taxonomy must not care which transport carried the
        request."""
        pendings: List[_Pending] = []
        for obj, dl, span in items:
            if faults.ENABLED:
                faults.fire(faults.WEBHOOK_ENQUEUE)
            pendings.append(_Pending(obj, deadline=dl, span=span))
        with self._rate_lock:
            self._arrivals += len(pendings)
        now = time.monotonic()
        stopped = False
        queued_any = False
        evictions: List[_Pending] = []
        refused: List[_Pending] = []   # queue-bound sheds
        expired: List[_Pending] = []   # dead-on-arrival budgets
        with self._cv:
            if self._stop:
                stopped = True
            else:
                for p in pendings:
                    if p.deadline is not None and now > p.deadline:
                        expired.append(p)
                        continue
                    evicted: Optional[_Pending] = None
                    if (self.max_pending
                            and len(self._pending) >= self.max_pending):
                        if p.low_value:
                            refused.append(p)
                            continue
                        if self._pending_dryruns > 0:
                            for i, q in enumerate(self._pending):
                                if q.low_value:
                                    evicted = self._pending.pop(i)
                                    self._pending_dryruns -= 1
                                    break
                        if evicted is None:
                            refused.append(p)
                            continue
                    self._pending.append(p)
                    if p.low_value:
                        self._pending_dryruns += 1
                    queued_any = True
                    if evicted is not None:
                        evictions.append(evicted)
            if queued_any:
                self._cv.notify()
        # deliveries happen OUTSIDE the cv, exactly as in review():
        # Event.set and registry records must not run under the producer
        # lock
        if stopped:
            for p in pendings:
                if p.queue_span is not None:
                    p.queue_span.end()
                p.error = BatcherStopped("webhook batcher is stopped")
                p.event.set()
            return pendings
        for ev in evictions:
            with self._rate_lock:
                self.sheds += 1
            if ev.queue_span is not None:
                ev.queue_span.end()
            ev.error = _deadline.OverloadShed(
                "dry-run admission preempted by enforced work at the "
                "pending bound"
            )
            ev.event.set()
            record_shed("queue_full_dryrun")
        for p in refused:
            with self._rate_lock:
                self.sheds += 1
            if p.queue_span is not None:
                p.queue_span.end()
            record_shed("queue_full_dryrun" if p.low_value else "queue_full")
            p.error = _deadline.OverloadShed(
                "micro-batcher pending queue is at its bound "
                f"({self.max_pending})"
            )
            p.event.set()
        for p in expired:
            if p.queue_span is not None:
                p.queue_span.end()
            p.error = _deadline.DeadlineExceeded(
                "admission deadline budget exhausted before evaluation"
            )
            p.event.set()
        return pendings

    def wait(self, p: "_Pending"):
        """Block until a submit_many pending completes — the same tail
        as review(): a deadline-bounded event wait, then the error (if
        any) raised on the waiter's thread."""
        if p.deadline is None:
            p.event.wait()
        elif not p.event.wait(timeout=max(0.0, p.deadline - time.monotonic())):
            raise _deadline.DeadlineExceeded(
                "admission deadline budget exhausted"
            )
        if p.error is not None:
            raise p.error
        return p.result

    def _run(self):
        import time as _time

        last_batch_size = 0
        last_dispatch_end = 0.0
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop and not self._pending:
                    return
            # adapt OUTSIDE the cv: the service model takes the driver
            # lock (predicted_batch_ms -> _n_constraints_total), and a
            # long driver hold (audit sweep, snapshot capture) must not
            # stall every enqueue behind the cv — producers only need
            # the cv to append and notify
            target, deadline = self._adapt()
            with self._cv:
                # load-adaptive accumulation (docs/fleet.md): with a
                # calibrated service model and observed load, hold the
                # window until the equilibrium target batch arrives or
                # the adaptive deadline lapses (each arrival notifies the
                # cv, so a filled target dispatches immediately)
                goal = min(target, self.max_batch)
                if target > 1 and len(self._pending) < goal:
                    t_end = _time.monotonic() + deadline
                    while (
                        not self._stop and len(self._pending) < goal
                    ):
                        # a deadline-budgeted member must never be held
                        # past its own budget by the adaptive window:
                        # clamp to the earliest pending deadline (minus
                        # a dispatch margin), recomputed each pass since
                        # new arrivals may carry tighter budgets
                        cut = t_end
                        for p in self._pending:
                            if p.deadline is not None:
                                cut = min(
                                    cut,
                                    p.deadline
                                    - self.DEADLINE_CLAMP_MARGIN_S,
                                )
                        remaining = cut - _time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                else:
                    # static heuristic (no calibration / low load): open
                    # the window only under observed, RECENT concurrency
                    # (several already waiting, or the previous batch
                    # coalesced moments ago) — a sequential client
                    # issuing one request at a time must never pay the
                    # window, or the sparse-traffic p99 absorbs it
                    # wholesale; and a burst minutes ago must not tax
                    # today's lone request
                    recent = (
                        _time.monotonic() - last_dispatch_end
                        < 5 * self.window_s
                    )
                    concurrent = len(self._pending) > 1 or (
                        last_batch_size > 1 and recent
                    )
                    if concurrent and len(self._pending) < self.max_batch:
                        self._cv.wait(timeout=self.window_s)
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch:]
                if self._pending_dryruns:
                    self._pending_dryruns -= sum(
                        1 for q in batch if q.low_value
                    )
                last_batch_size = len(batch)
                self._busy = True
            # the batch is drained: queue-wait ends here for every member
            # (deadline-refused ones included — their wait was real)
            for p in batch:
                if p.queue_span is not None:
                    p.queue_span.end()
                    record_stage(
                        WEBHOOK_QUEUE_M,
                        p.queue_span.stop - p.queue_span.start,
                    )
            # refuse past-deadline work before paying a dispatch for it:
            # the waiter has already (or will imminently) time out, and
            # evaluating its review is pure wasted device time
            now = _time.monotonic()
            live = []
            for p in batch:
                if p.deadline is not None and now > p.deadline:
                    p.error = _deadline.DeadlineExceeded(
                        "admission deadline budget exhausted in queue"
                    )
                    p.event.set()
                else:
                    live.append(p)
            batch = live
            # one batch span serving N request spans: linked to each, and
            # every span of the batch trace (this one + the driver's stage
            # spans) mirrors into each request trace, so request traces
            # stay self-contained (obs/trace.py batch_span)
            bsp = None
            btoken = None
            if batch:
                record_batch_size(len(batch))
                req_spans = [p.span for p in batch if p.span is not None]
                if req_spans:  # un-traced batches skip span work entirely
                    # adaptation state on the dispatch span, mirrored
                    # into every member's trace: /debug/traces shows WHY
                    # a given request waited (target it accumulated
                    # toward, deadline, the load that set them)
                    bsp = obstrace.batch_span(
                        "webhook.batch", req_spans, batch_size=len(batch),
                        batch_target=self._target_batch,
                        batch_deadline_ms=round(self._deadline_s * 1e3, 3),
                        offered_load_rps=round(self._load_rps, 1),
                    )
                    # activate (not a bare CURRENT.set): the sampling
                    # profiler's stage correlation reads the cross-
                    # thread registry, and this loop is exactly the
                    # dispatch thread it needs to see (obs/profiler.py)
                    btoken = obstrace.activate(bsp)
            try:
                if batch:
                    responses = self._client.review_batch(
                        [p.obj for p in batch]
                    )
                    if bsp is not None:
                        obstrace.deactivate(btoken)
                        btoken = None
                        bsp.end()
                        bsp = None
                    for p, resp in zip(batch, responses):
                        p.result = resp
                        p.event.set()
            except Exception:
                # batched failure: fall back to per-request evaluation so one
                # poisoned review can't fail the whole window — but check
                # each request's remaining budget first; a request whose
                # deadline lapsed during the failed dispatch gets an
                # explicit deadline error, not another evaluation.
                # The batch span ends FIRST: fallback evaluations run under
                # each request's OWN span, not the batch span — otherwise
                # every fallback's stage spans would mirror into all N
                # request traces (and keep appending after their waiters
                # were released)
                if bsp is not None:
                    obstrace.deactivate(btoken)
                    btoken = None
                    bsp.end()
                    bsp = None
                for p in batch:
                    if (
                        p.deadline is not None
                        and _time.monotonic() > p.deadline
                    ):
                        p.error = _deadline.DeadlineExceeded(
                            "admission deadline budget exhausted during "
                            "per-request fallback"
                        )
                        p.event.set()
                        continue
                    try:
                        if p.span is not None:
                            with obstrace.use_span(p.span):
                                p.result = self._client.review(p.obj)
                        else:
                            p.result = self._client.review(p.obj)
                    except Exception as e:
                        p.error = e
                    p.event.set()
            finally:
                if btoken is not None:
                    obstrace.deactivate(btoken)
                if bsp is not None:
                    bsp.end()  # idempotent on the success path
                self._busy = False
                last_dispatch_end = _time.monotonic()

    def drain(self, deadline_s: float) -> dict:
        """Flush the queue for a graceful shutdown (docs/fleet.md drain
        protocol): wait until every already-enqueued request has been
        dispatched AND answered (or refused by its own admission budget —
        each queued member's deadline still bounds it individually), up
        to `deadline_s`.  The batcher keeps running — new arrivals during
        the drain are NOT rejected here; stopping intake is the server's
        job (WebhookServer.drain), sequenced by the supervisor before
        this flush.  Returns {"pending_start", "drained", "overran",
        "drain_ms"}; never blocks past the deadline."""
        t0 = time.monotonic()
        deadline = t0 + max(0.0, deadline_s)
        with self._cv:
            pending_start = len(self._pending)
        while time.monotonic() < deadline:
            with self._cv:
                if not self._pending and not self._busy:
                    break
                # each arrival/dispatch notifies the cv; cap the wait so
                # a missed notify cannot overrun the budget
                self._cv.wait(
                    timeout=min(0.005, max(0.0,
                                           deadline - time.monotonic()))
                )
        with self._cv:
            leftover = len(self._pending) or (1 if self._busy else 0)
        dur = time.monotonic() - t0
        return {
            "pending_start": pending_start,
            "drained": leftover == 0,
            "overran": leftover > 0,
            "drain_ms": round(dur * 1e3, 3),
        }

    def stop(self):
        # clear the driver's load hint: a stopped batcher must not pin
        # throughput routing for whoever evaluates next (tests, restarts)
        try:
            _predict, set_load = self._service_model()
            if set_load is not None:
                set_load(None)
        except Exception:
            log.debug("clearing driver load hint failed on batcher stop",
                      exc_info=True)
        # drain under the cv lock: a request appended concurrently either
        # lands before the drain (gets BatcherStopped here) or after _stop
        # is set (review() rejects it) — no pending can be left waiting on
        # an event forever (the shutdown race this replaces)
        with self._cv:
            self._stop = True
            drained, self._pending = self._pending, []
            self._pending_dryruns = 0
            for p in drained:
                p.error = BatcherStopped(
                    "webhook batcher stopped before evaluation"
                )
                p.event.set()
            self._cv.notify_all()
        join_thread(self._thread, 2.0, "webhook micro-batcher loop")


def gc_sweep(settled: int) -> int:
    """One sweep of the webhook's collector, generational as the
    collector is when enabled: the young generations (what the requests
    since the last sweep left alive, their cycles among it), and the old
    one only once it holds a quarter more than ``settled``, its size
    after its last collection (CPython's own rule) -> the size the next
    sweep compares with.  A full collection each sweep scanned every
    object the serving state keeps (the request memo's entries) with the
    GIL held: 62-567 ms every 5 s in a young replica on an H100's host
    (chip_smoke's phase 12), each a reactor stall past the edge
    objective's 50 ms."""
    import gc

    if len(gc.get_objects(generation=2)) - settled > settled // 4:
        gc.collect()
        return len(gc.get_objects(generation=2))
    gc.collect(1)
    return settled


class WebhookServer:
    """HTTP(S) listener for /v1/admit + /v1/admitlabel + health endpoints."""

    def __init__(
        self,
        validation_handler: ValidationHandler,
        label_handler: Optional[NamespaceLabelHandler] = None,
        port: int = 8443,
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
        readiness_check=None,  # callable -> bool (tracker.satisfied)
        deadline_budget_s: Optional[float] = None,
        health_status: Optional[Callable[[], dict]] = None,
    ):
        self.validation_handler = validation_handler
        self.label_handler = label_handler or NamespaceLabelHandler()
        self.port = port
        self.certfile = certfile
        self.keyfile = keyfile
        self.readiness_check = readiness_check
        # per-request deadline budget: every admission request entering
        # this server carries monotonic_now + budget as its deadline; the
        # batching client and driver fallbacks refuse work past it, and
        # the handler converts exhaustion into an explicit fail-open or
        # fail-closed decision (never a socket timeout)
        self.deadline_budget_s = deadline_budget_s
        # degradation visibility: a callable returning a status dict
        # (e.g. {"tpu_breaker": driver.breaker_status()}) surfaced on
        # /healthz (degraded marker) and /statusz (full JSON)
        self.health_status = health_status
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ssl_context: Optional[ssl.SSLContext] = None
        self._stopping = False
        # graceful drain (docs/fleet.md): a draining server answers 503 to
        # NEW admission requests (the front door/LB has already stopped
        # routing here; stragglers must fail over, not land new work) while
        # in-flight evaluation finishes under its own deadline budgets.
        # Health endpoints keep answering; /readyz reports not-ready.
        self._draining = False

    def _status_snapshot(self) -> Optional[dict]:
        if self.health_status is None:
            return None
        try:
            return self.health_status()
        except Exception:
            log.exception("health status callable failed")
            return None

    def reload_certs(self, certfile: str, keyfile: str):
        """Hot-swap the serving cert: new handshakes pick up the reloaded
        chain (cert rotation must not require a listener restart)."""
        self.certfile, self.keyfile = certfile, keyfile
        if self._ssl_context is not None:
            self._ssl_context.load_cert_chain(certfile, keyfile)

    def start(self):
        # idempotent: a double start must REPLACE the previous listener
        # and GC sweeper, not leak them — the old sweeper thread otherwise
        # outlives the server forever, and the old socket still holds the
        # port the new bind needs.  shutdown() only when serve_forever is
        # actually running: on a server whose loop never started (a prior
        # start() died mid-body) it would wait forever on the
        # __is_shut_down event that only serve_forever sets.
        if self._server is not None:
            if self._thread is not None and self._thread.is_alive():
                self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None
        if getattr(self, "_gc_stop", None) is not None:
            self._gc_stop.set()
            self._gc_stop = None
        self._stopping = False  # a stopped server may be restarted
        self._draining = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: without HTTP/1.1 every admission request pays a
            # fresh TLS handshake (the apiserver reuses connections);
            # responses always carry Content-Length below, as 1.1 requires
            protocol_version = "HTTP/1.1"
            # headers and body flush as separate TCP segments; with Nagle
            # on, the body write stalls ~40ms behind the peer's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                # access logging at DEBUG only, and never for probe/scrape
                # paths (/healthz-style and the /debug/* surface): a
                # misconfigured prober polling /debug/traces must not spam
                # stderr at admission rates
                path = (getattr(self, "path", "") or "").split("?", 1)[0]
                if path in QUIET_PATHS or path.startswith(DEBUG_PREFIX):
                    return
                if log.isEnabledFor(10):  # logging.DEBUG
                    log.debug("%s - %s", self.address_string(), fmt % args)

            def _send_json(self, code: int, payload: dict):
                self._send_bytes(code, "application/json",
                                 json.dumps(payload).encode())

            def _send_text(self, code: int, text: str):
                self._send_bytes(code, "text/plain", text.encode())

            def _send_bytes(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if self.close_connection:
                    # advertise the close decided by framing/shutdown so
                    # keep-alive clients don't reuse a dying connection
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # a GET may legally carry a body too
                if self._read_body() is None:
                    return
                if self._stopped():
                    return
                # healthz/readyz (reference main.go:193-196)
                if self.path == "/healthz":
                    body = "ok"
                    st = outer._status_snapshot()
                    if st and any(
                        isinstance(v, dict)
                        and v.get("state") not in (None, "closed")
                        for v in st.values()
                    ):
                        # degraded-but-serving is still healthy: the
                        # interpreter tier answers while the breaker is
                        # open, so the pod must NOT be restarted — the
                        # marker makes the state visible to probes/humans
                        body = "ok (degraded)"
                    self._send_text(200, body)
                elif self.path == "/statusz":
                    # machine-readable degradation ladder state (breaker
                    # state machine, trip counts, time degraded)
                    self._send_json(200, outer._status_snapshot() or {})
                elif self.path == "/readyz":
                    if outer._draining:
                        # draining is an orderly not-ready: LB health
                        # checks pull the backend while /healthz stays ok
                        self._send_text(503, "draining")
                        return
                    ready = (
                        outer.readiness_check() if outer.readiness_check else True
                    )
                    self._send_text(200 if ready else 500,
                                    "ok" if ready else "not ready")
                elif self.path.split("?", 1)[0].startswith(DEBUG_PREFIX):
                    self._debug_get()
                else:
                    self._send_text(404, "not found")

            def _debug_get(self):
                """Debug introspection surface, served by the shared
                DebugRouter (obs/debug.py) — the same routes (and the
                same hardened query parsing) the metrics exporter
                serves, so docs/tracing.md describes one contract:
                /debug/traces?min_ms=&limit=  recent completed traces
                /debug/stacks                 live thread-stack dump
                /debug/costs?top=             per-template cost ledger
                /debug/slo                    SLO burn-rate status"""
                from urllib.parse import urlsplit

                parts = urlsplit(self.path)
                self._send_bytes(
                    *get_router().handle(parts.path, parts.query)
                )

            # Admission payloads are small; a body this large is abuse or
            # corruption, never a legitimate AdmissionReview.
            MAX_BODY = 32 * 1024 * 1024

            def _read_body(self) -> Optional[bytes]:
                """Always consume the request body: under HTTP/1.1
                keep-alive, unread body bytes would be parsed as the NEXT
                request line, poisoning the persistent connection.

                Returns None when the body could not be framed — in that
                case an error response has already been sent and the
                caller must bail out (the Go reference's net/http parses
                chunked transparently; evaluating an unframeable body as
                b"" would be a fail-open admission decision)."""
                te = self.headers.get("Transfer-Encoding")
                if te:
                    if te.strip().lower() == "chunked":
                        return self._read_chunked()
                    self.close_connection = True
                    self._send_text(411, "Length Required")
                    return None
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self.close_connection = True
                    self._send_text(400, "bad Content-Length")
                    return None
                if length > self.MAX_BODY:
                    self.close_connection = True
                    self._send_text(413, "body too large")
                    return None
                return self.rfile.read(length) if length > 0 else b""

            def _read_chunked(self) -> Optional[bytes]:
                """RFC 7230 §4.1 chunked decoding (net/http does this
                inside the transport; here it is explicit)."""
                chunks: list = []
                total = 0
                try:
                    while True:
                        line = self.rfile.readline(65536)
                        if not line.endswith(b"\n"):
                            raise ValueError("chunk size line overflow")
                        size = int(line.strip().split(b";", 1)[0], 16)
                        if size < 0:
                            raise ValueError("negative chunk size")
                        if size == 0:
                            # consume trailers up to the blank line,
                            # bounded like the body (an endless trailer
                            # stream must not pin the handler thread)
                            budget = 65536
                            while True:
                                trailer = self.rfile.readline(65536)
                                if trailer in (b"\r\n", b"\n", b""):
                                    break
                                budget -= len(trailer)
                                if budget < 0:
                                    raise ValueError("trailers too large")
                            return b"".join(chunks)
                        total += size
                        if total > self.MAX_BODY:
                            raise ValueError("chunked body too large")
                        data = self.rfile.read(size)
                        if len(data) != size:
                            raise ValueError("truncated chunk")
                        chunks.append(data)
                        crlf = self.rfile.read(2)
                        if crlf not in (b"\r\n",):
                            raise ValueError("missing chunk terminator")
                except (ValueError, OSError):
                    # malformed framing: the connection cannot be reused
                    # and the request must NOT be evaluated as empty
                    self.close_connection = True
                    self._send_text(400, "malformed chunked body")
                    return None

            def _stopped(self) -> bool:
                """After stop(), established keep-alive connections must
                not keep receiving admission decisions from a server the
                process considers down (HTTP/1.0 closed per response, so
                this was free before keep-alive)."""
                if outer._stopping:
                    self.close_connection = True
                    self._send_text(503, "shutting down")
                    return True
                return False

            def do_POST(self):
                body = self._read_body()
                if body is None:
                    return
                if self._stopped():
                    return
                if outer._draining:
                    # explicit refusal, never a fabricated verdict: the
                    # caller (front door / apiserver) fails over to a
                    # live replica or applies its failurePolicy
                    self.close_connection = True
                    self._send_text(503, "draining")
                    return
                if self.path not in ("/v1/admit", "/v1/admitlabel"):
                    self._send_text(404, "not found")
                    return
                try:
                    review = json.loads(body or b"{}")
                    req = review.get("request") or {}
                    if not isinstance(req, dict):
                        # {"request": "bogus"} is a malformed envelope,
                        # not an empty request — it must get the same
                        # explicit 500 AdmissionReview, and everything
                        # below (budget parse, uid extraction) assumes
                        # a dict
                        raise TypeError(
                            "AdmissionReview request must be an "
                            f"object, got {type(req).__name__}"
                        )
                except Exception as e:  # malformed envelope
                    log.exception("bad admission request")
                    resp = AdmissionResponse(False, str(e), 500)
                    self._send_json(
                        200,
                        {
                            "apiVersion": "admission.k8s.io/v1beta1",
                            "kind": "AdmissionReview",
                            "response": resp.to_dict(uid=""),
                        },
                    )
                    return
                # end-to-end deadline: the budget is min()
                # over every bound the request carries — the configured
                # --admission-deadline-budget-ms, the AdmissionReview's
                # own request.timeoutSeconds (the webhook config's
                # timeout, when the caller stamps it — opportunistic,
                # never required), and the REMAINING wire budget a
                # fleet front door forwarded in X-GK-Deadline-Ms.  A replica behind the door re-enters
                # the budget with what is left of the caller's patience,
                # never a fresh allowance; an already-expired budget is
                # refused at the first downstream stage (batcher
                # enqueue), surfacing the explicit fail-open/closed
                # decision within microseconds.
                budget = _deadline.effective_budget_s(
                    outer.deadline_budget_s,
                    _deadline.parse_timeout_seconds(req),
                    _deadline.parse_header_ms(
                        self.headers.get(_deadline.DEADLINE_HEADER)
                    ),
                )
                token = None
                if budget is not None:
                    token = _deadline.push(budget)
                try:
                    # W3C trace context: adopt the apiserver's trace id so
                    # the deny log line and /debug/traces entry correlate
                    # with the upstream request
                    with obstrace.root_span(
                        "admission",
                        traceparent=self.headers.get("traceparent"),
                        path=self.path,
                        uid=str(req.get("uid", "")),
                    ) as rsp:
                        if self.path == "/v1/admit":
                            resp = outer.validation_handler.handle(req)
                        else:
                            resp = outer.label_handler.handle(req)
                        rsp.set_attrs(allowed=resp.allowed, code=resp.code)
                except Exception as e:  # handler defect
                    log.exception("bad admission request")
                    resp = AdmissionResponse(False, str(e), 500)
                finally:
                    if token is not None:
                        _deadline.pop(token)
                self._send_json(
                    200,
                    {
                        "apiVersion": "admission.k8s.io/v1beta1",
                        "kind": "AdmissionReview",
                        "response": resp.to_dict(uid=req.get("uid", "")),
                    },
                )

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._server.server_address[1]
        if self.certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.certfile, self.keyfile)
            self._ssl_context = ctx
            self._server.socket = ctx.wrap_socket(
                self._server.socket, server_side=True
            )
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="webhook", daemon=True
        )
        self._thread.start()
        # p99 tactic: move everything allocated so far (compiled policies,
        # packed tensors, module graph) out of the cyclic GC's generations —
        # a gen-2 collection scanning a 100k-object inventory otherwise
        # injects multi-ms pauses into the admission path — then take the
        # collector OFF the admission path entirely: automatic collections
        # triggered mid-request inject ms-scale pauses exactly at p99.
        # Refcounting still frees the (acyclic) request traffic; a
        # background sweeper collects the rare cycles every few seconds.
        import gc

        gc.collect()
        gc.freeze()
        gc.disable()
        stop_evt = threading.Event()
        self._gc_stop = stop_evt

        def _sweep():
            # closes over the Event only: capturing self would pin a
            # dropped server forever and re-reading self._gc_stop races
            # stop()'s None reset
            settled = len(gc.get_objects(generation=2))
            while not stop_evt.wait(5.0):
                settled = gc_sweep(settled)

        threading.Thread(target=_sweep, name="webhook-gc", daemon=True).start()

    def drain(self, draining: bool = True):
        """Enter (or leave) draining: new admission POSTs answer 503 and
        /readyz reports not-ready, while /healthz and the debug surface
        keep serving.  The supervisor's graceful-drain sequence is
        eject-from-front-door -> server.drain() -> batcher.drain(budget)
        -> stop() (docs/fleet.md)."""
        self._draining = bool(draining)

    def stop(self):
        if getattr(self, "_gc_stop", None) is not None:
            self._gc_stop.set()
            self._gc_stop = None
            import gc

            gc.enable()
            # unfreeze too: repeated start/stop cycles (tests, embedders)
            # would otherwise grow the permanent generation monotonically
            # and any cycles frozen on a later start() would leak forever
            gc.unfreeze()
        # established keep-alive connections keep their handler threads
        # alive past shutdown(); the flag makes them 503 + close instead
        # of serving admission decisions from a stopped server
        self._stopping = True
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
