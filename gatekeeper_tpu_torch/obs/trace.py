"""Span primitive + process tracer: always-on, ~zero-cost tracing for the
two hot paths (admission webhook, batched audit sweep).

Design constraints:

- Monotonic timings only.  Span start/end come from ``time.perf_counter``;
  a wall-clock anchor is captured ONCE at import so completed traces can
  be rendered with absolute timestamps without any hot-path ``time.time``
  call (tools/check_observability.py enforces this).
- Explicit context passing.  The current span rides a ``contextvars``
  ContextVar per thread; code that hops threads (the webhook
  micro-batcher) captures the span object explicitly and re-establishes
  it on the far side with ``use_span``.
- Batch linkage.  One micro-batched TPU dispatch serves N admission
  requests.  The batch runs under its own (non-exported) trace whose
  root span carries ``links`` to the N request spans; every span of the
  batch trace is MIRRORED into each linked request trace on finish, so a
  request trace is self-contained — its stage spans (queue-wait, pack,
  cache lookup, dispatch, render) are all present and disjoint in time,
  which is what lets their durations sum to the request total.
- Bounded retention.  Completed exported traces land in a ring buffer
  (``/debug/traces`` serves it); any trace slower than the configured
  threshold is ALSO logged with its full stage breakdown (the slow-trace
  sampler).  With the default configuration the only per-span costs are
  a few attribute writes and one deque append per trace.

Stage names are stable strings (the ``stage`` attribute): ``queue_wait``,
``cache_lookup``, ``pack``, ``compile``, ``dispatch``, ``fetch``,
``render``, ``inventory``, ``status_write``.  docs/tracing.md documents
the model.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("gatekeeper.obs")

# wall-clock anchor for rendering monotonic offsets as absolute time;
# captured once at import, never on a hot path
_WALL_ANCHOR = time.time()  # wall-clock: ok (import-time anchor)
_PERF_ANCHOR = time.perf_counter()

# stable stage names (see module docstring)
QUEUE_WAIT = "queue_wait"
CACHE_LOOKUP = "cache_lookup"
PACK = "pack"
COMPILE = "compile"
DISPATCH = "dispatch"
FETCH = "fetch"
RENDER = "render"
INVENTORY = "inventory"
STATUS_WRITE = "status_write"

_TRACEPARENT_VERSION = "00"


def wall_time(perf_t: float) -> float:
    """Absolute (epoch) time of a perf_counter reading, via the anchor."""
    return _WALL_ANCHOR + (perf_t - _PERF_ANCHOR)


def _new_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


#: public alias for producers that mint a trace id WITHOUT building a
#: trace — the event-loop edge stamps X-GK-Trace-Id on head-unsampled
#: requests from this, skipping Span/Trace allocation entirely
new_trace_id = _new_trace_id


# span ids only need process-local uniqueness (trace ids carry the global
# entropy); a counter is ~3x cheaper than getrandbits+format per span
_SPAN_SEQ = __import__("itertools").count(1)


def _new_span_id() -> str:
    return f"{next(_SPAN_SEQ):016x}"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """W3C traceparent -> (trace_id, parent_span_id), or None when the
    header is absent/malformed.  Only version 00 fields are consumed;
    unknown versions still yield ids when the field shapes line up
    (forward compatibility, per the spec)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    # W3C: version is exactly two lowercase hex digits and never "ff";
    # unknown (higher) versions still yield ids when the field shapes
    # line up — that is the spec's forward-compatibility rule
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    if version != version.lower() or trace_id != trace_id.lower() \
            or span_id != span_id.lower():
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-01"


class Trace:
    """One trace: a trace_id plus the finished-span records that belong
    to it.  ``mirrors`` receive a copy of every finished span record
    (the batch-trace -> request-trace fan-out)."""

    __slots__ = (
        "trace_id", "spans", "mirrors", "export", "root", "root_record",
        "remote_parent",
    )

    def __init__(self, trace_id: Optional[str] = None, export: bool = True,
                 remote_parent: Optional[str] = None):
        self.trace_id = trace_id or _new_trace_id()
        self.spans: List[dict] = []  # finished span records, end order
        self.mirrors: List["Trace"] = []
        self.export = export
        self.root: Optional["Span"] = None
        self.root_record: Optional[dict] = None
        self.remote_parent = remote_parent

    def to_dict(self) -> dict:
        # the root is tracked explicitly: mirrored batch records may append
        # after the root ended, so "last span" is not a root identity
        root = self.root_record or (self.spans[-1] if self.spans else {})
        return {
            "trace_id": self.trace_id,
            "root": root.get("name", ""),
            "start_ts": round(wall_time(root.get("start", _PERF_ANCHOR)), 6),
            "duration_ms": root.get("duration_ms", 0.0),
            "remote_parent": self.remote_parent,
            "spans": list(self.spans),
        }


class Span:
    """One timed operation.  Finish with ``end()`` (or use the tracer's
    context managers); a finished span becomes an immutable dict record
    on its trace (and the trace's mirrors)."""

    __slots__ = (
        "name", "trace", "span_id", "parent_id", "start", "stop",
        "attrs", "events", "links",
    )

    def __init__(self, name: str, trace: Trace,
                 parent_id: Optional[str] = None,
                 start: Optional[float] = None, **attrs):
        self.name = name
        self.trace = trace
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.start = time.perf_counter() if start is None else start
        self.stop: Optional[float] = None
        self.attrs: Dict[str, object] = attrs
        self.events: List[dict] = []
        self.links: List[Tuple[str, str]] = []

    def set_attrs(self, **attrs):
        self.attrs.update(attrs)

    def add_event(self, name: str, **attrs):
        self.events.append({
            "name": name,
            "offset_ms": round((time.perf_counter() - self.start) * 1e3, 3),
            **attrs,
        })

    def link(self, trace_id: str, span_id: str):
        self.links.append((trace_id, span_id))

    def record(self) -> dict:
        rec = {
            "name": self.name,
            "trace_id": self.trace.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration_ms": round(((self.stop or self.start) - self.start)
                                 * 1e3, 4),
        }
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        if self.events:
            rec["events"] = list(self.events)
        if self.links:
            rec["links"] = [
                {"trace_id": t, "span_id": s} for t, s in self.links
            ]
        return rec

    def end(self, stop: Optional[float] = None):
        if self.stop is not None:
            return  # idempotent: double-end keeps the first timing
        self.stop = time.perf_counter() if stop is None else stop
        rec = self.record()
        tr = self.trace
        tr.spans.append(rec)
        for m in tr.mirrors:
            m.spans.append(rec)
        if tr.root is self:
            tr.root_record = rec
            _TRACER.complete(tr)


# the per-thread (per-context) active span
CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "gk_current_span", default=None
)

# Cross-thread mirror of CURRENT for the sampling profiler
# (obs/profiler.py): a sampler thread cannot read another thread's
# contextvars, so span (de)activation also writes this ident-keyed dict.
# GIL-atomic dict ops only — no lock on the span hot path.
_ACTIVE_BY_THREAD: Dict[int, Span] = {}


def _thread_activate(span: Optional[Span]) -> Optional[Span]:
    ident = threading.get_ident()
    prev = _ACTIVE_BY_THREAD.get(ident)
    if span is None:
        _ACTIVE_BY_THREAD.pop(ident, None)
    else:
        _ACTIVE_BY_THREAD[ident] = span
    return prev


def _thread_restore(prev: Optional[Span]) -> None:
    ident = threading.get_ident()
    if prev is None:
        _ACTIVE_BY_THREAD.pop(ident, None)
    else:
        _ACTIVE_BY_THREAD[ident] = prev


def active_spans() -> Dict[int, Span]:
    """Snapshot of {thread_ident: active span} — the profiler's stage-
    correlation input.  A copy: the sampler must never iterate the live
    dict while request threads mutate it."""
    return dict(_ACTIVE_BY_THREAD)


def activate(span: Span):
    """Establish ``span`` as CURRENT for this thread (contextvar AND the
    profiler's thread registry) without a context manager — for code
    that brackets activation across non-lexical scopes (the micro-
    batcher's dispatch loop).  Returns an opaque state for
    :func:`deactivate`."""
    token = CURRENT.set(span)
    prev = _thread_activate(span)
    return (token, prev)


def deactivate(state) -> None:
    token, prev = state
    CURRENT.reset(token)
    _thread_restore(prev)


class Tracer:
    """Process tracer: ring buffer of completed traces + slow sampler."""

    def __init__(self, buffer_size: int = 256,
                 slow_threshold_s: float = 0.25,
                 sample_rate: float = 1.0):
        self._lock = threading.Lock()
        self.configure(buffer_size, slow_threshold_s, sample_rate)

    def configure(self, buffer_size: Optional[int] = None,
                  slow_threshold_s: Optional[float] = None,
                  sample_rate: Optional[float] = None):
        with self._lock:
            if buffer_size is not None:
                self._ring: deque = deque(maxlen=max(int(buffer_size), 1))
            if slow_threshold_s is not None:
                self.slow_threshold_s = float(slow_threshold_s)
            if sample_rate is not None:
                self.sample_rate = min(max(float(sample_rate), 0.0), 1.0)

    def sampled(self) -> bool:
        """Head-sampling decision for high-rate span producers (the
        event-loop edge): decide ONCE at request origination whether
        this trace would be retained, so an un-sampled request skips
        span allocation entirely instead of paying the full per-span
        cost and being dropped at completion anyway.  The trade: the
        slow-trace tail criterion only sees head-sampled requests on
        such producers — at sample_rate 1.0 (the default) nothing
        changes and every trace still completes through the ring."""
        r = self.sample_rate
        return r >= 1.0 or (r > 0.0 and random.random() < r)

    # ---- completion --------------------------------------------------------

    def complete(self, trace: Trace):
        if not trace.export:
            return
        # the explicit root record, never spans[-1]: a mirrored batch
        # record appended concurrently from another thread could
        # otherwise be mistaken for the root
        root = trace.root_record
        dur_s = (root["duration_ms"] / 1e3) if root else 0.0
        slow = (
            self.slow_threshold_s > 0 and dur_s >= self.slow_threshold_s
        )
        if slow or self.sample_rate >= 1.0 or (
            self.sample_rate > 0.0 and random.random() < self.sample_rate
        ):
            with self._lock:
                self._ring.append(trace)
        if slow:
            try:
                log.warning(
                    "slow trace %s (%s, %.1fms >= %.0fms threshold)",
                    trace.trace_id,
                    root.get("name", "?") if root else "?",
                    dur_s * 1e3, self.slow_threshold_s * 1e3,
                    extra={"kv": {
                        "event_type": "slow_trace",
                        "trace_id": trace.trace_id,
                        "duration_ms": root["duration_ms"] if root else 0.0,
                        "stages": stage_breakdown(trace.to_dict()),
                    }},
                )
            except Exception:  # sampling must never break the request
                log.exception("slow-trace sampler failed")

    # ---- retrieval ---------------------------------------------------------

    def traces(self, min_ms: float = 0.0,
               limit: Optional[int] = None) -> List[dict]:
        """Completed traces, newest first, optionally filtered by root
        duration (the ``/debug/traces?min_ms=`` contract)."""
        with self._lock:
            snap = list(self._ring)
        out = []
        for tr in reversed(snap):
            d = tr.to_dict()
            if d["duration_ms"] >= min_ms:
                out.append(d)
            if limit is not None and len(out) >= limit:
                break
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()


_TRACER = Tracer(
    buffer_size=int(os.environ.get("GK_TRACE_BUFFER", "256")),
    slow_threshold_s=float(os.environ.get("GK_SLOW_TRACE_MS", "250")) / 1e3,
    sample_rate=float(os.environ.get("GK_TRACE_SAMPLE", "1.0")),
)


def get_tracer() -> Tracer:
    return _TRACER


def configure(buffer_size: Optional[int] = None,
              slow_threshold_s: Optional[float] = None,
              sample_rate: Optional[float] = None):
    _TRACER.configure(buffer_size, slow_threshold_s, sample_rate)


def stage_breakdown(trace_dict: dict) -> Dict[str, float]:
    """{stage: total_ms} over a trace's stage-tagged spans (disjoint by
    construction, so the values sum toward the root duration)."""
    out: Dict[str, float] = {}
    for s in trace_dict.get("spans", ()):
        stage = (s.get("attrs") or {}).get("stage")
        if stage:
            out[stage] = round(out.get(stage, 0.0) + s["duration_ms"], 4)
    return out


# ---- context helpers --------------------------------------------------------


def current_span() -> Optional[Span]:
    return CURRENT.get()


def current_trace_id() -> Optional[str]:
    sp = CURRENT.get()
    return sp.trace.trace_id if sp is not None else None


def set_attrs(**attrs):
    """Attach attributes to the active span (no-op without one)."""
    sp = CURRENT.get()
    if sp is not None:
        sp.attrs.update(attrs)


def add_event(name: str, **attrs):
    """Record a point-in-time event on the active span (no-op without
    one) — e.g. the fault plane stamping where an injected fault landed."""
    sp = CURRENT.get()
    if sp is not None:
        sp.add_event(name, **attrs)


class _SpanCtx:
    """Context manager for one span; establishes it as CURRENT inside."""

    __slots__ = ("span", "_token", "_prev_active")

    def __init__(self, span: Span):
        self.span = span
        self._token = None
        self._prev_active = None

    def __enter__(self) -> Span:
        self._token = CURRENT.set(self.span)
        self._prev_active = _thread_activate(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.span.attrs.setdefault("error", repr(exc))
        CURRENT.reset(self._token)
        _thread_restore(self._prev_active)
        self.span.end()
        return False


def root_span(name: str, traceparent: Optional[str] = None,
              start: Optional[float] = None, **attrs) -> _SpanCtx:
    """Start a new exported trace rooted at this span.  ``traceparent``
    (the W3C header value) adopts the caller's trace id so the deny log
    line and /debug/traces entry correlate with the upstream trace.
    ``start`` backdates the root to an already-measured perf_counter
    anchor (the front door's accept time), so child stage spans recorded
    against that anchor stay inside the root duration."""
    parent = parse_traceparent(traceparent)
    if parent is not None:
        tr = Trace(trace_id=parent[0], remote_parent=parent[1])
        sp = Span(name, tr, parent_id=parent[1], start=start, **attrs)
    else:
        tr = Trace()
        sp = Span(name, tr, start=start, **attrs)
    # fleet identity on every root span: /debug/traces entries from N
    # replicas merged by an aggregator stay attributable (docs/fleet.md)
    from ..util import replica_id

    rid = replica_id()
    if rid:
        sp.attrs.setdefault("replica_id", rid)
    tr.root = sp
    return _SpanCtx(sp)


class _NoopSpan:
    """Inert span for un-traced callers: every method swallows its
    arguments.  One shared instance — the no-active-trace path allocates
    NOTHING, which is what keeps callers outside a trace (bench's direct
    handler drive, embedders) at ~zero cost."""

    __slots__ = ()

    def set_attrs(self, **attrs):
        pass

    def add_event(self, name: str, **attrs):
        pass

    def link(self, trace_id: str, span_id: str):
        pass

    def end(self, stop: Optional[float] = None):
        pass


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return _NOOP_SPAN

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_SPAN = _NoopSpan()
_NOOP_CTX = _NoopCtx()


def span(name: str, stage: Optional[str] = None, **attrs):
    """Child span of the current span.  Without an active span this is
    the shared no-op context — one ContextVar read and nothing else."""
    cur = CURRENT.get()
    if cur is None:
        return _NOOP_CTX
    sp = Span(name, cur.trace, parent_id=cur.span_id, **attrs)
    if stage:
        sp.attrs["stage"] = stage
    return _SpanCtx(sp)


class _UseCtx:
    """Context manager that re-establishes an explicitly-passed span as
    CURRENT without ending it on exit (cross-thread context passing —
    e.g. the batcher's per-request fallback evaluating under each
    request's own span)."""

    __slots__ = ("_span", "_token", "_prev_active")

    def __init__(self, sp: Span):
        self._span = sp
        self._token = None
        self._prev_active = None

    def __enter__(self) -> Span:
        self._token = CURRENT.set(self._span)
        self._prev_active = _thread_activate(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        CURRENT.reset(self._token)
        _thread_restore(self._prev_active)
        return False


def use_span(sp: Span) -> _UseCtx:
    return _UseCtx(sp)


def detached_span(name: str, parent: Optional[Span] = None,
                  start: Optional[float] = None, **attrs) -> Span:
    """A span NOT established as CURRENT — for callers that hold it
    across threads or end it from another place (the batcher's
    queue-wait span).  Parent defaults to the current span."""
    cur = parent if parent is not None else CURRENT.get()
    if cur is not None:
        return Span(name, cur.trace, parent_id=cur.span_id, start=start,
                    **attrs)
    return Span(name, Trace(export=False), start=start, **attrs)


def batch_span(name: str, link_spans: List[Span], **attrs) -> Span:
    """Root span of a batch trace serving N request spans: linked to each
    request span, and every span of the batch trace mirrors into each
    linked request trace (self-contained request traces).  The batch
    trace itself is never exported — the mirrors are its output."""
    tr = Trace(export=False)
    seen = set()
    for rs in link_spans:
        if rs is None or not rs.trace.export:
            continue
        if id(rs.trace) not in seen:
            seen.add(id(rs.trace))
            tr.mirrors.append(rs.trace)
    sp = Span(name, tr, **attrs)
    tr.root = sp
    for rs in link_spans:
        if rs is not None:
            sp.link(rs.trace.trace_id, rs.span_id)
    sp.attrs.setdefault("batch_size", len(link_spans))
    return sp


def record_span(name: str, start: float, stop: float,
                stage: Optional[str] = None, **attrs):
    """Record an already-measured interval as a finished span under the
    current span (no-op cost without one).  For code that has its own
    perf_counter bracketing (the driver's sweep stats)."""
    cur = CURRENT.get()
    if cur is None:
        return None
    sp = Span(name, cur.trace, parent_id=cur.span_id, start=start, **attrs)
    if stage:
        sp.attrs["stage"] = stage
    sp.end(stop=stop)
    return sp


def dump_stacks() -> dict:
    """Thread-stack snapshot for /debug/stacks: every live thread's name,
    ident, daemon flag, and current frames — the hang-diagnosis view the
    fault plane's hang mode needs."""
    import sys
    import traceback

    frames = sys._current_frames()
    threads = []
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        stack = traceback.format_stack(frame) if frame is not None else []
        threads.append({
            "name": t.name,
            "ident": t.ident,
            "daemon": t.daemon,
            "alive": t.is_alive(),
            "stack": [ln.rstrip() for ln in stack],
        })
    return {"thread_count": len(threads), "threads": threads}


def traces_json(min_ms: float = 0.0, limit: Optional[int] = None) -> str:
    return json.dumps({"traces": _TRACER.traces(min_ms=min_ms, limit=limit)})
