"""Event-loop front door — the selectors rebuild of the
serving edge.

:class:`EventFrontDoor` keeps the entire FrontDoor control plane —
`_choose`'s locked inflight reservation, ejection/readmission streaks,
the /readyz prober, the retry token bucket, `_refuse`'s shed/expired
taxonomy, `stats()` — and replaces only the data plane: one reactor
thread (fleet/evloop.py) running non-blocking accept/read/write state
machines over persistent pipelined client connections, with the
replica hop spoken over the batched wire protocol (fleet/wireproto.py)
instead of HTTP.

Data-plane shape:

* **Byte-splice proxying.**  The door never parses an AdmissionReview:
  it routes on headers, and the body bytes travel to the replica
  verbatim inside a request record.  The uid regex runs only on the
  refusal paths, exactly as on the old edge.
* **Tick-chunking.**  Requests parsed out of one client read accumulate
  per backend and flush as ONE chunk frame at the end of the read (and
  at every loop tick) — a client that pipelines N requests hands the
  replica's micro-batcher an N-record chunk.
* **Ordered pipelining.**  HTTP/1.1 pipelined responses must return in
  request order; each connection keeps its requests in a slot queue and
  writes a completed response only when every earlier slot has written.
* **Same contracts, same names.**  The six WIRE_STAGES mark on a
  per-request stage clock (explicit-parent spans — the loop thread
  serves many requests interleaved, so CURRENT is meaningless);
  X-GK-Deadline-Ms rides the wire as the record's remaining-budget
  field; shed/expired refusals, Retry-After, the retry budget, 502
  naming the last backend, X-GK-Trace-Id / X-GK-Replica — all
  byte-compatible with frontdoor.py (the parameterized slowloris and
  contract tests hold both doors to it).
"""

from __future__ import annotations

import errno
import itertools
import logging
import selectors
import socket
import threading
import time
from collections import deque
from http.client import responses as _HTTP_REASONS
from typing import Dict, Optional, Set

from .. import deadline as _deadline
from .. import faults
from .. import logging as gklog
from ..metrics.catalog import (
    record_frontdoor_requests,
    record_frontdoor_stages,
    record_shed,
    record_wire_backlog_stall,
    record_wire_flush,
    record_wire_reconnect,
)
from ..obs import trace as obstrace
from .evloop import Conn, EventLoop, HttpError, HttpRequestParser, \
    http_response
from .frontdoor import (
    _UID_RE,
    FrontDoor,
    OUTCOME_BACKEND_ERROR,
    OUTCOME_BAD_REQUEST,
    OUTCOME_EXPIRED,
    OUTCOME_NO_BACKEND,
    OUTCOME_OK,
    OUTCOME_SHED,
    STAGE_ACCEPT,
    STAGE_PROXY_CONNECT,
    STAGE_READ_BODY,
    STAGE_REPLICA_WAIT,
    STAGE_ROUTE_CHOOSE,
    STAGE_WRITE_BACK,
    _admission_review_body,
)
from . import wireproto

log = gklog.get("fleet.evdoor")


def _reason(code: int) -> str:
    return _HTTP_REASONS.get(code, "Unknown")


# pre-rendered fragments of the dominant response shape (200/json,
# keep-alive); _respond joins these around the per-request headers so
# the hot path never goes through http_response's f-string assembly
_RESP_200_HEAD = (b"HTTP/1.1 200 OK\r\nContent-Type: application/json"
                  b"\r\nContent-Length: ")
_RESP_200_TAIL = b"\r\nConnection: keep-alive\r\n\r\n"


class _EdgeStageClock:
    """Explicit-parent twin of frontdoor._StageClock: the loop thread
    interleaves many requests, so stage spans attach to each request's
    own wire root instead of the thread's CURRENT.  Same contiguity
    contract — mark() closes the open interval and opens the next, so
    stage durations sum to the wire duration with no dark time.

    Marks accumulate as plain tuples on the reactor thread and
    materialize ONCE at response time (:meth:`flush`): a single
    registry lock hold covers all six stage observes, and span objects
    are built only when the request's trace was head-sampled (root is
    not None).  Stage HISTOGRAMS follow the same head-sampling decision
    as the trace — an un-sampled request's clock only advances its
    stage boundary (one perf_counter read per mark, no tuples, no
    registry work); ``gk_frontdoor_requests_total`` keeps the exact
    request counts regardless (docs/tracing.md)."""

    __slots__ = ("t", "root", "marks")

    def __init__(self, start: float, root):
        self.t = start
        self.root = root
        self.marks: list = []    # (stage, start, stop, attrs-or-None)

    def mark(self, stage: str, now: Optional[float] = None,
             **attrs) -> float:
        if now is None:
            now = time.perf_counter()
        if self.root is not None:
            self.marks.append((stage, self.t, now, attrs or None))
        self.t = now
        return now

    def flush(self, trace_id: str = "") -> None:
        """Materialize the accumulated marks of a head-sampled request:
        a single registry lock hold covers all six stage observes (the
        exemplar links to THIS request's trace), then the stage spans
        are built against the wire root.  Un-sampled requests are a
        no-op by construction — their clock kept no marks."""
        marks, self.marks = self.marks, []
        if not marks:
            return
        record_frontdoor_stages(
            [(stage, stop - start) for stage, start, stop, _a in marks],
            exemplar_trace_id=trace_id,
        )
        root = self.root
        for stage, start, stop, attrs in marks:
            obstrace.detached_span(
                "wire." + stage, parent=root, start=start,
                stage=stage, **(attrs or {}),
            ).end(stop=stop)


class _EdgeRequest:
    """One in-flight request: its response slot on the client
    connection (pipelined ordering), its wire root + stage clock, and
    the proxy attempt state the retry path walks."""

    __slots__ = ("conn", "root", "clock", "tid", "body", "path",
                 "deadline", "req_id", "tried", "attempt", "backend",
                 "t_attempt", "pending_stage", "done", "out",
                 "close_after", "last_exc")

    def __init__(self, conn, root, clock, tid, path, body):
        self.conn = conn
        self.root = root
        self.clock = clock
        self.tid = tid
        self.path = path
        self.body = body
        self.deadline: Optional[float] = None
        self.req_id = 0
        self.tried: Set[int] = set()
        self.attempt = 0
        self.backend = None
        self.t_attempt = 0.0
        self.pending_stage: Optional[str] = None
        self.done = False
        self.out: Optional[bytes] = None
        self.close_after = False
        self.last_exc: Optional[BaseException] = None


class _ClientConn(Conn):
    """Inbound (apiserver-side) connection: incremental HTTP parser plus
    the ordered response slot queue."""

    def __init__(self, door: "EventFrontDoor", loop: EventLoop, sock):
        self.door = door
        self.parser = HttpRequestParser(door.MAX_BODY)
        self.slots: deque = deque()
        self.errored = False
        super().__init__(loop, sock)

    def on_bytes(self, data: bytes) -> None:
        if self.errored:
            return   # refusal queued; the connection is closing
        now = time.perf_counter()
        try:
            reqs = self.parser.feed(data, now)
        except HttpError as e:
            self.errored = True
            for parsed in getattr(e, "completed", ()):
                self.door._handle_request(self, parsed)
            self.door._client_http_error(self, e)
            self.door._flush_dirty()
            return
        for parsed in reqs:
            self.door._handle_request(self, parsed)
        # everything this read produced flushes as one chunk per backend
        self.door._flush_dirty()

    def on_closed(self, exc) -> None:
        self.door._client_closed(self, exc)

    def flush_slots(self) -> None:
        """Write every contiguous completed slot as ONE buffer — under
        pipelining a tick's worth of responses leaves in a single
        send() instead of one syscall per response."""
        out = []
        while self.slots and self.slots[0].done:
            req = self.slots.popleft()
            if req.out:
                out.append(req.out)
            if req.close_after:
                if out:
                    self.write(b"".join(out))
                self.close(None)
                return
        if out:
            self.write(out[0] if len(out) == 1 else b"".join(out))

    # completed responses coalesce through the door's dirty set and
    # leave at tick end, same as wire chunks
    flush = flush_slots


class _WireClient(Conn):
    """Outbound persistent connection to one backend's wire listener.
    Request records queue per tick and flush as one chunk frame;
    response chunks complete requests through the door."""

    def __init__(self, door: "EventFrontDoor", loop: EventLoop, backend):
        self.door = door
        self.backend = backend
        self.decoder = wireproto.FrameDecoder()
        self.pending: Dict[int, _EdgeRequest] = {}
        # write-backlog stall episode start (None = the socket is
        # keeping up); closed by on_writable when the backlog drains
        self._stall_t0: Optional[float] = None
        # gklint: disable=unbounded-queue -- drained every loop tick;
        # admission to it is bounded upstream by the door's per-backend
        # inflight reservation (_choose), the same cap the old edge had
        self.queued: list = []   # _EdgeRequests awaiting the tick flush
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        rc = sock.connect_ex((backend.host, backend.port))
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK,
                      errno.EAGAIN):
            sock.close()
            raise ConnectionRefusedError(rc, "wire connect failed")
        super().__init__(loop, sock)

    def enqueue(self, req: _EdgeRequest) -> None:
        self.pending[req.req_id] = req
        self.queued.append(req)
        self.door._dirty.add(self)

    def flush(self) -> None:
        if not self.queued or self.closed:
            return
        flushed, self.queued = self.queued, []
        records = []
        live = []
        for req in flushed:
            if req.done:
                continue   # orphaned pre-flush (client disconnected)
            rem_ms = None
            if req.deadline is not None:
                rem_ms = max(0.0,
                             (req.deadline - time.monotonic()) * 1e3)
            tp = ""
            root = req.root
            if root is not None and getattr(root, "trace", None) is not None:
                tp = obstrace.format_traceparent(
                    root.trace.trace_id, root.span_id)
            records.append(wireproto.RequestRecord(
                req.req_id, req.path, req.body,
                deadline_ms=rem_ms, traceparent=tp,
            ))
            live.append(req)
        if not records:
            return
        chunk = wireproto.encode_request_chunk(records)
        # proxy_connect closes when the chunk is ASSEMBLED, before the
        # send: the stage attributes the door's own proxy work.  The
        # send syscall wakes the replica process, and on a co-located
        # single-core host the scheduler may run the replica's whole
        # turnaround before the door's next instruction — an after-send
        # boundary would charge that turnaround to proxy_connect or
        # replica_wait depending on scheduling luck (docs/tracing.md).
        rid = self.backend.replica_id
        for req in live:
            req.clock.mark(STAGE_PROXY_CONNECT, backend=rid)
            req.pending_stage = STAGE_REPLICA_WAIT
        self.door._wire_note("request_chunks", 1)
        self.door._wire_note("bytes_out", len(chunk))
        self.door._wire_sample("request", len(records))
        self.write(chunk)
        if self._wlen > 0 and self._stall_t0 is None:
            # the chunk did not leave in one send: a backlog-stall
            # episode opens; on_writable closes it when the kernel
            # buffer catches up
            self._stall_t0 = time.monotonic()

    def on_bytes(self, data: bytes) -> None:
        self.door._wire_note("bytes_in", len(data))
        try:
            chunks = self.decoder.feed(data)
        except wireproto.ProtocolError:
            # Conn closes us right after this raise; the counter is the
            # only trace a corrupt stream leaves once the bytes are gone
            self.door._wire_note("decode_errors", 1)
            raise
        for kind, records in chunks:
            if kind == wireproto.KIND_RESPONSE:
                self.door._wire_note("response_chunks", 1)
                self.door._wire_sample("response", len(records))
                self.door._complete_chunk(self, records)

    def on_writable(self) -> None:
        t0 = self._stall_t0
        if t0 is not None:
            self._stall_t0 = None
            record_wire_backlog_stall(self.backend.replica_id,
                                      time.monotonic() - t0)

    def on_closed(self, exc) -> None:
        if self._stall_t0 is not None:
            # the episode ends with the connection: charge what we saw
            record_wire_backlog_stall(self.backend.replica_id,
                                      time.monotonic() - self._stall_t0)
            self._stall_t0 = None
        self.door._wire_client_lost(self, exc)


class EventFrontDoor(FrontDoor):
    """FrontDoor with the thread-per-request HTTP data plane swapped
    for the reactor + batched-wire-protocol edge.  Backends are wire
    listener ports (fleet/wirelistener.py); pass ``probe_port`` per
    backend so the /readyz readmission prober can keep speaking HTTP to
    the replica's webhook listener."""

    # clients stalled mid-request are swept on this cadence (bounded by
    # header_timeout_s, so a tight test timeout still sweeps in time)
    SWEEP_INTERVAL_S = 0.05
    # GKW1 wire-telemetry flush cadence: tick-batched counts leave for
    # the registry on this gate, not per tick — the registry lock must
    # not inflate with tick rate
    WIRE_FLUSH_S = 0.25
    # chunk-batch-size histogram samples kept per flush window
    WIRE_SAMPLE_CAP = 256

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # GKW1 wire telemetry (loop thread only): plain dict increments
        # on the hot path, flushed through record_wire_flush on the
        # WIRE_FLUSH_S gate inside _flush_dirty
        self._wstats: Dict[str, int] = {}
        self._wrecs: list = []
        self._wflush_t = time.monotonic()
        # backends that have had a wire conn at least once: a rebuild
        # for one of these counts as a reconnect (loop thread only)
        self._wire_seen: Set[str] = set()
        self._loop: Optional[EventLoop] = None
        self._lsock: Optional[socket.socket] = None
        self._clients: Set[_ClientConn] = set()
        self._wire: Dict[str, _WireClient] = {}
        # conns (wire AND client) with buffered output; flushed once per
        # reactor tick so pipelined traffic coalesces into whole chunks
        self._dirty: Set[Conn] = set()
        # (outcome, backend) -> n, flushed with the dirty set: the hot
        # path pays a dict increment instead of a registry lock
        self._outcomes: Dict = {}
        # the roster list is append-only during __init__, so identity ->
        # index is stable; saves the locked list scan per dispatch
        self._bidx: Dict[int, int] = {
            id(b): i for i, b in enumerate(self.backends)
        }
        self._req_ids = itertools.count(1)

    def _next_req_id(self) -> int:
        """Request ids are u32 on the wire (wireproto masks them), so
        the pending-map key must be masked identically or, after 2^32
        requests, responses stop matching pending entries.  0 stays
        reserved as _EdgeRequest's unset sentinel."""
        rid = next(self._req_ids) & 0xFFFFFFFF
        if rid == 0:
            rid = next(self._req_ids) & 0xFFFFFFFF
        return rid

    # ---- lifecycle -------------------------------------------------------

    def start(self):
        if self._loop is not None and self._loop.running:
            return self   # idempotent: the edge is already serving
        self.stop()       # reap any half-stopped state
        self._loop = EventLoop("evdoor")
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind(("0.0.0.0", self.port))
        lsock.listen(1024)
        lsock.setblocking(False)
        self.port = lsock.getsockname()[1]
        self._lsock = lsock
        self._loop.register(lsock, selectors.EVENT_READ, self._accept)
        self._loop.add_tick_hook(self._flush_dirty)
        self._loop.start()
        self._loop.call_soon_threadsafe(self._schedule_sweep)
        # reactor flight deck: loop-lag heartbeat, slow-callback
        # attribution, the stall watchdog, and /debug/connz rows
        try:
            from ..obs import reactorobs

            reactorobs.attach(self._loop, "evdoor")
            reactorobs.register_door(self)
        except Exception:
            log.exception("reactor telemetry attach failed")
        self._prober_stop.clear()
        self._prober = threading.Thread(
            target=self._probe_loop, name="evdoor-probe", daemon=True
        )
        self._prober.start()
        return self

    def stop(self):
        self._prober_stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
            self._prober = None
        if self._loop is not None:
            try:
                from ..obs import reactorobs

                reactorobs.unregister_door(self)
                reactorobs.detach(self._loop)
            except Exception:
                log.exception("reactor telemetry detach failed")
            self._loop.stop()
            self._loop = None
        for c in list(self._clients):
            try:
                c.sock.close()
            except OSError:
                pass
        self._clients.clear()
        for wc in list(self._wire.values()):
            try:
                wc.sock.close()
            except OSError:
                pass
        self._wire.clear()
        self._dirty.clear()
        if self._outcomes:  # loop is stopped; drain the last tick's counts
            counts, self._outcomes = self._outcomes, {}
            record_frontdoor_requests(counts)
        if self._wstats or self._wrecs:  # and the last wire window
            wstats, self._wstats = self._wstats, {}
            wrecs, self._wrecs = self._wrecs, []
            record_wire_flush("door", wstats, wrecs)
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
            self._lsock = None

    # ---- loop plumbing ---------------------------------------------------

    def _accept(self, mask: int) -> None:
        while True:
            try:
                sock, _addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            self._clients.add(_ClientConn(self, self._loop, sock))

    def _flush_dirty(self) -> None:
        if self._outcomes:
            counts, self._outcomes = self._outcomes, {}
            record_frontdoor_requests(counts)
        if self._wstats or self._wrecs:
            now = time.monotonic()
            if now - self._wflush_t >= self.WIRE_FLUSH_S:
                self._wflush_t = now
                wstats, self._wstats = self._wstats, {}
                wrecs, self._wrecs = self._wrecs, []
                record_wire_flush("door", wstats, wrecs)
        if not self._dirty:
            return
        dirty, self._dirty = self._dirty, set()
        for c in dirty:
            c.flush()

    def _count_outcome(self, outcome: str, backend: str = "") -> None:
        key = (outcome, backend)
        self._outcomes[key] = self._outcomes.get(key, 0) + 1

    def _wire_note(self, key: str, n: int) -> None:
        self._wstats[key] = self._wstats.get(key, 0) + n

    def _wire_sample(self, kind: str, n_records: int) -> None:
        if len(self._wrecs) < self.WIRE_SAMPLE_CAP:
            self._wrecs.append((kind, n_records))

    def _schedule_sweep(self) -> None:
        interval = min(self.SWEEP_INTERVAL_S,
                       max(self.header_timeout_s / 4.0, 0.01))
        self._loop.call_later(interval, self._sweep)

    def _sweep(self) -> None:
        """Slow-client hardening (reactor edition): a
        connection stalled mid-HEADERS past header_timeout_s closes
        silently (slowloris gets nothing); stalled mid-BODY answers 408
        then closes.  Idle keep-alive connections are left alone."""
        now = time.monotonic()
        for c in list(self._clients):
            if c.closed or c.parser.idle:
                continue
            if now - c.last_activity <= self.header_timeout_s:
                continue
            if c.parser.mid_body:
                self._count_outcome(OUTCOME_BAD_REQUEST)
                c.write(http_response(408, "Request Timeout",
                                      "text/plain",
                                      b"request body timeout",
                                      close=True))
            c.close(None)
        if self._loop is not None:
            self._schedule_sweep()

    def _client_closed(self, conn: _ClientConn, exc) -> None:
        self._clients.discard(conn)
        self._dirty.discard(conn)
        for req in conn.slots:
            # a slot with an open pending_stage holds a backend
            # reservation (_choose) — release it NOW, exactly like
            # _expire, or the disconnect pins backend.inflight forever
            # and a bounded door sheds every later request.  No error
            # charge: the replica did nothing wrong, the client left.
            if not req.done and req.pending_stage is not None \
                    and req.backend is not None:
                backend = req.backend
                wc = self._wire.get(backend.replica_id)
                if wc is not None:
                    wc.pending.pop(req.req_id, None)
                req.pending_stage = None
                with backend.lock:
                    backend.inflight -= 1
            req.done = True     # orphaned: late completions are no-ops

    def _client_http_error(self, conn: _ClientConn,
                           e: HttpError) -> None:
        """Parser-level refusals keep the old door's wire shape: 400
        for a bad Content-Length, 413 before the body is read — each
        under its own (tiny) wire root so bad requests still trace."""
        body = {400: b"bad Content-Length",
                413: b"body too large"}.get(e.code,
                                            e.message.encode())
        start = conn.parser.t_start
        if start is None:
            start = time.perf_counter()
        if obstrace.get_tracer().sampled():
            wsp = obstrace.root_span("wire", start=start, path="").span
            tid = wsp.trace.trace_id
        else:
            wsp, tid = None, obstrace.new_trace_id()
        clock = _EdgeStageClock(start, wsp)
        clock.mark(STAGE_ACCEPT)
        if wsp is not None:
            wsp.set_attrs(outcome=OUTCOME_BAD_REQUEST)
        self._count_outcome(OUTCOME_BAD_REQUEST)
        req = _EdgeRequest(conn, wsp, clock, tid, "", b"")
        req.close_after = True
        conn.slots.append(req)
        self._respond(req, e.code, "text/plain", body, close=True)

    # ---- request intake --------------------------------------------------

    def _handle_request(self, conn: _ClientConn, parsed) -> None:
        method, target, headers, body, t_start, t_headers, t_body = parsed
        if method != "POST":
            req = _EdgeRequest(conn, None, None, "", target, b"")
            conn.slots.append(req)
            if method == "GET":
                threading.Thread(
                    target=self._get_worker, args=(req, target),
                    name="evdoor-get", daemon=True,
                ).start()
            else:
                self._respond(req, 501, "text/plain",
                              b"unsupported method")
            return
        tp = headers.get("traceparent")
        if tp is not None or obstrace.get_tracer().sampled():
            # a caller-carried traceparent always traces: correlation
            # with the upstream trace outweighs the head-sampling save
            wsp = obstrace.root_span(
                "wire", traceparent=tp, start=t_start, path=target,
            ).span
            tid = wsp.trace.trace_id
        else:
            wsp, tid = None, obstrace.new_trace_id()
        clock = _EdgeStageClock(t_start, wsp)
        if wsp is not None:
            clock.mark(STAGE_ACCEPT, now=t_headers)
            clock.mark(STAGE_READ_BODY, now=t_body)
        else:
            clock.t = t_body   # un-sampled: advance the boundary only
        req = _EdgeRequest(conn, wsp, clock, tid, target, body)
        conn.slots.append(req)
        dl_hdr = headers.get(_deadline.DEADLINE_HEADER.lower())
        if dl_hdr is not None or self.admission_budget_s is not None:
            budget = _deadline.effective_budget_s(
                self.admission_budget_s,
                _deadline.parse_header_ms(dl_hdr),
            )
            if budget is not None:
                if budget <= 0:
                    self._refuse(req, expired=True)
                    return
                req.deadline = time.monotonic() + budget
                self._loop.call_later(budget,
                                      lambda r=req: self._expire(r))
        if not self._has_capacity():
            self._refuse(req, expired=False)
            return
        self._dispatch(req)

    def _dispatch(self, req: _EdgeRequest) -> None:
        """One proxy attempt: reserve a backend (the base class's locked
        reservation — identical shed semantics), queue the request
        record on its wire client, arm nothing else; completion,
        expiry, or connection loss drive what happens next."""
        try:
            backend = self._choose(exclude=req.tried)
        except _deadline.OverloadShed:
            self._refuse(req, expired=False)
            return
        if backend is None:
            self._no_backend(
                req, f"no fleet backend answered: {req.last_exc!r}")
            return
        idx = self._bidx.get(id(backend))
        if idx is None:
            with backend.lock:
                backend.inflight -= 1
            self._dispatch(req)   # raced a roster mutation; re-choose
            return
        if req.attempt > 0 and not self.retry_budget.take():
            with backend.lock:
                backend.inflight -= 1
            gklog.log_event(
                log, "front-door retry denied: retry budget empty",
                level=logging.WARNING,
                event_type="frontdoor_retry_denied",
            )
            self._no_backend(req, "no fleet backend answered: "
                                  "retry budget empty")
            return
        req.tried.add(idx)
        req.backend = backend
        self._local.last_backend = backend.replica_id
        req.t_attempt = req.clock.mark(STAGE_ROUTE_CHOOSE,
                                       attempt=req.attempt)
        req.pending_stage = STAGE_PROXY_CONNECT
        try:
            if faults.ENABLED:
                faults.fire(faults.OVERLOAD_STORM)
            rid = backend.replica_id
            wc = self._wire.get(rid)
            if wc is None or wc.closed:
                if rid in self._wire_seen:
                    # a PREVIOUS persistent conn to this backend died
                    # (lost entries are popped, so wc is None here):
                    # this build is a reconnect, not first contact
                    record_wire_reconnect(rid)
                else:
                    self._wire_seen.add(rid)
                wc = _WireClient(self, self._loop, backend)
                self._wire[rid] = wc
            req.req_id = self._next_req_id()
            wc.enqueue(req)
        except Exception as e:
            self._attempt_failed(req, e)

    # ---- completion / failure paths --------------------------------------

    def _complete(self, wc: _WireClient, rec) -> None:
        self._complete_chunk(wc, (rec,))

    def _complete_chunk(self, wc: _WireClient, records) -> None:
        """A whole response chunk from one backend: per-record
        completion, with the shared-state bookkeeping (inflight,
        served, latency notes) batched under ONE backend-lock hold for
        the chunk instead of one per record."""
        backend = wc.backend
        rid = backend.replica_id
        pending = wc.pending
        done = []
        for rec in records:
            req = pending.pop(rec.req_id, None)
            if req is None or req.done:
                continue
            now = req.clock.mark(STAGE_REPLICA_WAIT, backend=rid)
            req.pending_stage = None
            done.append((req, rec, now))
        if not done:
            return
        mono = time.monotonic()
        with backend.lock:
            backend.inflight -= len(done)
            backend.served += len(done)
            backend.consecutive_errors = 0
            for req, _rec, now in done:
                backend.lat.append(
                    (mono, (now - req.t_attempt) * 1e3))
        if backend.ejected and any(r.status != 503 for _q, r, _n in done):
            self._readmit(backend, "served while ejected")
        for req, rec, _now in done:
            if req.attempt > 0:
                self.retries += 1
            outcome = (OUTCOME_OK if 200 <= rec.status < 300
                       else OUTCOME_BACKEND_ERROR)
            if req.root is not None:
                req.root.set_attrs(outcome=outcome, backend=rid,
                                   status=rec.status)
            self._count_outcome(outcome, rid)
            self._respond(req, rec.status, "application/json", rec.body,
                          replica=rid)

    def _attempt_failed(self, req: _EdgeRequest, exc: Exception) -> None:
        """Mirror of forward()'s per-attempt except block: close the
        in-flight stage, charge the backend's error streak (refused
        ejects immediately), then retry on a DIFFERENT backend or
        answer the explicit 502."""
        req.last_exc = exc
        backend = req.backend
        if req.pending_stage and backend is not None:
            req.clock.mark(req.pending_stage,
                           backend=backend.replica_id,
                           error=type(exc).__name__)
            req.pending_stage = None
        if backend is not None:
            with backend.lock:
                backend.inflight -= 1
                backend.errors += 1
                backend.consecutive_errors += 1
                streak = backend.consecutive_errors
            if isinstance(exc, ConnectionRefusedError):
                self._eject(backend, "connection refused")
            elif streak >= self.EJECT_ERROR_STREAK:
                self._eject(backend, f"{streak} consecutive errors")
            gklog.log_event(
                log,
                f"backend {backend.replica_id} failed "
                f"({type(exc).__name__}: {exc}); "
                + ("retrying on a different backend"
                   if req.attempt < self.RETRY_LIMIT
                   else "retry budget spent"),
                level=logging.WARNING,
                event_type="frontdoor_backend_error",
                backend=backend.replica_id, attempt=req.attempt,
            )
        req.attempt += 1
        if req.deadline is not None and time.monotonic() > req.deadline:
            self._refuse(req, expired=True)
            return
        if req.attempt <= self.RETRY_LIMIT:
            self._dispatch(req)
        else:
            self._no_backend(req,
                             f"no fleet backend answered: {exc!r}")

    def _wire_client_lost(self, wc: _WireClient, exc) -> None:
        self._wire.pop(wc.backend.replica_id, None)
        self._dirty.discard(wc)
        if exc is None:
            exc = ConnectionResetError("wire connection closed")
        pending = list(wc.pending.values())
        wc.pending.clear()
        for req in pending:
            if not req.done:
                self._attempt_failed(req, exc)

    def _expire(self, req: _EdgeRequest) -> None:
        """Deadline timer: abandon the in-flight attempt (a late record
        is dropped in _complete), charge the backend exactly like a
        deadline-clamped timeout on the old edge, and answer the
        explicit expired decision."""
        if req.done:
            return
        backend = req.backend
        if backend is not None:
            wc = self._wire.get(backend.replica_id)
            if wc is not None:
                wc.pending.pop(req.req_id, None)
            if req.pending_stage:
                req.clock.mark(req.pending_stage,
                               backend=backend.replica_id,
                               error="TimeoutError")
                req.pending_stage = None
            with backend.lock:
                backend.inflight -= 1
                backend.errors += 1
                backend.consecutive_errors += 1
                streak = backend.consecutive_errors
            if streak >= self.EJECT_ERROR_STREAK:
                self._eject(backend, f"{streak} consecutive errors "
                                     "(deadline-clamped timeouts)")
        self._refuse(req, expired=True)

    # ---- responses -------------------------------------------------------

    def _respond(self, req: _EdgeRequest, code: int, ctype: str,
                 body: bytes, replica: str = "",
                 retry_after: bool = False, close: bool = False) -> None:
        if (code == 200 and not close and not retry_after
                and ctype == "application/json"):
            # byte-identical fast lane for the dominant response shape:
            # skips http_response's f-string assembly on the hot path
            parts = [_RESP_200_HEAD, str(len(body)).encode("latin-1")]
            if replica:
                parts.append(b"\r\nX-GK-Replica: "
                             + replica.encode("latin-1"))
            if req.tid:
                parts.append(b"\r\nX-GK-Trace-Id: "
                             + req.tid.encode("latin-1"))
            parts.append(_RESP_200_TAIL)
            parts.append(body)
            req.out = b"".join(parts)
        else:
            extra = []
            if replica:
                extra.append(("X-GK-Replica", replica))
            if req.tid:
                extra.append(("X-GK-Trace-Id", req.tid))
            if retry_after:
                extra.append(("Retry-After", str(self.RETRY_AFTER_S)))
            req.out = http_response(code, _reason(code), ctype, body,
                                    tuple(extra), close=close)
        req.done = True
        if close:
            req.close_after = True
        if req.root is not None:
            # write_back covers splice + enqueue onto the client conn's
            # buffer; the kernel write coalesces at tick end with every
            # other response completed this round (docs/tracing.md).
            # Head-unsampled requests skip the mark+flush outright —
            # their clock kept no marks to materialize.
            req.clock.mark(STAGE_WRITE_BACK)
            req.clock.flush(req.tid)
            req.root.end()
        self._dirty.add(req.conn)

    def _refuse(self, req: _EdgeRequest, expired: bool) -> None:
        """Byte-for-byte the old door's _refuse: expired answers the
        explicit fail-open/closed verdict (HTTP 200, code 504 inside);
        shed answers 429 + Retry-After with the same verdict shape."""
        from ..webhook.policy import (
            DEADLINE_CODE,
            DEADLINE_MESSAGE,
            FAIL_OPEN_DEADLINE,
            FAIL_OPEN_SHED,
            SHED_CODE,
            SHED_MESSAGE,
        )

        if req.done:
            return
        m = _UID_RE.search(req.body or b"")
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
        with self._mu:
            self.sheds += 1
        if req.root is not None:
            req.root.set_attrs(outcome=outcome, shed_reason=reason)
        self._count_outcome(outcome)
        record_shed(reason)
        payload = _admission_review_body(
            uid, self.fail_open, msg, code, annot
        )
        self._respond(req, http_code, "application/json", payload,
                      retry_after=retry_after)

    def _no_backend(self, req: _EdgeRequest, msg: str) -> None:
        if req.done:
            return
        rid = req.backend.replica_id if req.backend is not None else ""
        if req.root is not None:
            req.root.set_attrs(outcome=OUTCOME_NO_BACKEND, backend=rid)
        self._count_outcome(OUTCOME_NO_BACKEND, rid)
        gklog.log_event(
            log, "front door exhausted its backends",
            level=logging.WARNING,
            event_type="frontdoor_no_backend", last_backend=rid,
        )
        self._respond(req, 502, "text/plain", msg.encode(), replica=rid)

    # ---- introspection ----------------------------------------------------

    def stats(self) -> dict:
        s = super().stats()
        try:
            from ..obs import reactorobs

            s["reactor"] = reactorobs.snapshot()
        except Exception:
            # introspection must never fail the /fleetz payload
            log.debug("reactor stats failed", exc_info=True)
        return s

    def connz(self) -> list:
        """Per-connection rows for /debug/connz (obs/reactorobs.py).
        Called from arbitrary threads; every read is a single attribute
        load of loop-thread-owned state — momentarily stale is fine,
        torn is impossible."""
        now = time.monotonic()
        rows = []
        for c in list(self._clients):
            if c.closed:
                continue
            p = c.parser
            state = ("errored" if c.errored
                     else "mid_body" if p.mid_body
                     else "idle" if p.idle
                     else "mid_headers")
            rows.append({
                "edge": "evdoor", "kind": "client",
                "age_s": round(now - c.created, 3),
                "idle_s": round(now - c.last_activity, 3),
                "bytes_in": c.bytes_in, "bytes_out": c.bytes_out,
                "write_backlog": c.write_backlog,
                "pipeline_depth": len(c.slots),
                "parser": state,
            })
        for rid, wc in list(self._wire.items()):
            if wc.closed:
                continue
            rows.append({
                "edge": "evdoor", "kind": "wire", "backend": rid,
                "age_s": round(now - wc.created, 3),
                "idle_s": round(now - wc.last_activity, 3),
                "bytes_in": wc.bytes_in, "bytes_out": wc.bytes_out,
                "write_backlog": wc.write_backlog,
                "pending_requests": len(wc.pending),
            })
        return rows

    # ---- GET endpoints (rare, served off-loop) ----------------------------

    def _get_worker(self, req: _EdgeRequest, target: str) -> None:
        try:
            code, ctype, body = self._get_response(target)
        except Exception as e:
            code, ctype, body = 500, "text/plain", str(e).encode()
        loop = self._loop
        if loop is not None:
            loop.call_soon_threadsafe(
                lambda: self._respond(req, code, ctype, body))

    def _get_response(self, target: str):
        import json as _json

        path, _, query = target.partition("?")
        if path == "/healthz":
            live = sum(
                1 for b in self.backends
                if not b.ejected
                and b.consecutive_errors < self.LIVE_ERROR_STREAK
            )
            return ((200 if live else 503), "text/plain",
                    b"ok" if live else b"no backends")
        if path == "/fleetz":
            return (200, "application/json",
                    _json.dumps(self.stats()).encode())
        if path == "/metrics":
            from ..metrics.exporter import (
                CONTENT_TYPE_TEXT,
                render_prometheus,
            )

            fed = self.federator
            body = (fed.render() if fed is not None
                    else render_prometheus())
            return 200, CONTENT_TYPE_TEXT, body.encode()
        if path.startswith("/debug/"):
            from ..obs.debug import get_router

            return get_router().handle(path, query)
        return 404, "text/plain", b"not found"
