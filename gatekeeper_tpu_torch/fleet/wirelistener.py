"""Replica-side batched wire listener.

The event-loop front door speaks the framed chunk protocol
(fleet/wireproto.py) to this listener instead of HTTP: one frame
carries every admission the door coalesced in an event-loop tick, the
AdmissionReview JSON is parsed HERE — exactly once on the whole wire
path — and the decoded chunk enters the micro-batcher through
``submit_many`` (one producer-lock round for N requests), which is the
entire point of the batched protocol.

Semantics mirror webhook/server.py's do_POST request for request:
draining/stopping answer 503, unknown paths 404, a malformed envelope
gets the explicit 200-wrapped 500 AdmissionReview, the deadline budget
is ``min(--admission-deadline-budget-ms, request.timeoutSeconds, the
remaining wire budget the door stamped on the record)``, and every
admission runs under an ``admission`` root span adopting the door's
traceparent.  The chunk's verdicts travel back as one response frame.

Threading: the event loop owns the sockets; decoded chunks are handed
to a small worker pool (policy evaluation blocks on the batcher), and
completed response frames are posted back to the loop thread for the
write.  The worker queue is bounded — a full queue sheds the whole
chunk with explicit overload verdicts (the same 200-wrapped 429 shape
the batcher's queue bound produces), never an unbounded backlog.
"""

from __future__ import annotations

import json
import queue
import selectors
import socket
import threading
import time
from typing import List, Optional

from .. import deadline as _deadline
from .. import logging as gklog
from ..metrics.catalog import record_shed, record_wire_flush
from ..obs import trace as obstrace
from ..util import join_thread
from .evloop import Conn, EventLoop
from .frontdoor import _UID_RE
from . import wireproto

log = gklog.get("fleet.wirelistener")

_ENVELOPE_HEAD = {"apiVersion": "admission.k8s.io/v1beta1",
                  "kind": "AdmissionReview"}


def _envelope(resp_dict: dict) -> bytes:
    return json.dumps(dict(_ENVELOPE_HEAD, response=resp_dict)).encode()


class _DoorConn(Conn):
    """One front-door connection: an incremental frame decoder feeding
    whole request chunks to the listener."""

    def __init__(self, listener: "WireListener", loop: EventLoop, sock):
        self.listener = listener
        self.decoder = wireproto.FrameDecoder()
        super().__init__(loop, sock)

    def on_bytes(self, data: bytes) -> None:
        self.listener._wire_note("bytes_in", len(data))
        try:
            chunks = self.decoder.feed(data)
        except wireproto.ProtocolError:
            # Conn closes us right after this raise; the counter is the
            # only trace a corrupt stream leaves once the bytes are gone
            self.listener._wire_note("decode_errors", 1)
            raise
        for kind, records in chunks:
            if kind == wireproto.KIND_REQUEST:
                self.listener._wire_note("request_chunks", 1)
                self.listener._wire_sample("request", len(records))
                self.listener._submit(self, records)

    def on_closed(self, exc) -> None:
        self.listener._conns.discard(self)


class WireListener:
    """Batch admission listener for one replica.

    ``handler`` must expose ``handle_many(items)`` (ValidationHandler);
    ``label_handler`` handles /v1/admitlabel records per request;
    ``server`` (the replica's WebhookServer, optional) contributes the
    draining/stopping predicates and the deadline budget default, so
    both listeners of a replica refuse in lockstep during a drain."""

    QUEUE_CHUNKS = 256
    # GKW1 wire-telemetry flush cadence (tick-gated, same reasoning as
    # EventFrontDoor.WIRE_FLUSH_S: registry traffic must not scale with
    # tick rate)
    WIRE_FLUSH_S = 0.25
    WIRE_SAMPLE_CAP = 256

    def __init__(self, handler, label_handler=None, server=None,
                 deadline_budget_s: Optional[float] = None,
                 port: int = 0, host: str = "0.0.0.0",
                 workers: int = 8, fail_open: bool = False):
        self.handler = handler
        self.label_handler = label_handler
        self.server = server
        self._deadline_budget_s = deadline_budget_s
        self.port = port
        self.host = host
        self.workers = max(1, int(workers))
        self.fail_open = (
            fail_open if handler is None
            else bool(getattr(handler, "fail_open", fail_open))
        )
        self.sheds = 0           # listener-level chunk-queue refusals
        self._mu = threading.Lock()
        self._loop: Optional[EventLoop] = None
        self._lsock: Optional[socket.socket] = None
        self._conns: set = set()
        self._q: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_CHUNKS)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # GKW1 wire telemetry: fed from the loop thread AND the worker
        # pool (responses are framed off-loop), so increments take the
        # listener lock; flushed on the WIRE_FLUSH_S gate by a tick hook
        self._wstats: dict = {}
        self._wrecs: list = []
        self._wflush_t = time.monotonic()

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "WireListener":
        self._stop.clear()
        self._loop = EventLoop("wirelistener")
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.host, self.port))
        lsock.listen(1024)
        lsock.setblocking(False)
        self.port = lsock.getsockname()[1]
        self._lsock = lsock
        self._loop.register(lsock, selectors.EVENT_READ, self._accept)
        self._loop.add_tick_hook(self._flush_wire)
        self._loop.start()
        # reactor flight deck: loop-lag heartbeat, stall watchdog, and
        # /debug/connz rows for the replica-side edge
        try:
            from ..obs import reactorobs

            reactorobs.attach(self._loop, "wirelistener")
            reactorobs.register_door(self)
        except Exception:
            log.exception("reactor telemetry attach failed")
        for i in range(self.workers):
            t = threading.Thread(target=self._worker,
                                 name=f"wirelistener-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for _ in self._threads:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                break
        if self._loop is not None:
            try:
                from ..obs import reactorobs

                reactorobs.unregister_door(self)
                reactorobs.detach(self._loop)
            except Exception:
                log.exception("reactor telemetry detach failed")
            self._loop.stop()
            self._loop = None
        for c in list(self._conns):
            try:
                c.sock.close()
            except OSError:
                pass
        self._conns.clear()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
            self._lsock = None
        for t in self._threads:
            join_thread(t, 2.0, "wirelistener worker")
        self._threads = []
        self._flush_wire(force=True)  # the final window must not vanish

    # ---- wire telemetry --------------------------------------------------

    def _wire_note(self, key: str, n: int) -> None:
        with self._mu:
            self._wstats[key] = self._wstats.get(key, 0) + n

    def _wire_sample(self, kind: str, n_records: int) -> None:
        with self._mu:
            if len(self._wrecs) < self.WIRE_SAMPLE_CAP:
                self._wrecs.append((kind, n_records))

    def _flush_wire(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._mu:
            if not self._wstats and not self._wrecs:
                return
            if not force and now - self._wflush_t < self.WIRE_FLUSH_S:
                return
            self._wflush_t = now
            wstats, self._wstats = self._wstats, {}
            wrecs, self._wrecs = self._wrecs, []
        record_wire_flush("replica", wstats, wrecs)

    def connz(self) -> list:
        """Per-connection rows for /debug/connz (obs/reactorobs.py):
        the front-door conns this replica is serving."""
        now = time.monotonic()
        rows = []
        for c in list(self._conns):
            if c.closed:
                continue
            rows.append({
                "edge": "wirelistener", "kind": "door",
                "age_s": round(now - c.created, 3),
                "idle_s": round(now - c.last_activity, 3),
                "bytes_in": c.bytes_in, "bytes_out": c.bytes_out,
                "write_backlog": c.write_backlog,
                "queued_chunks": self._q.qsize(),
            })
        return rows

    # ---- loop side -------------------------------------------------------

    def _accept(self, mask: int) -> None:
        while True:
            try:
                sock, _addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            self._conns.add(_DoorConn(self, self._loop, sock))

    def _submit(self, conn: _DoorConn, records: list) -> None:
        try:
            self._q.put_nowait((conn, records))
        except queue.Full:
            # bounded handoff: shed the WHOLE chunk with explicit
            # overload verdicts — the same 200-wrapped 429 shape the
            # batcher's queue bound produces, so the door-side taxonomy
            # cannot tell the two bounds apart (it should not)
            with self._mu:
                self.sheds += len(records)
            record_shed("wire_chunk_queue")
            out = [wireproto.ResponseRecord(r.req_id, 200,
                                            self._shed_body(r.body))
                   for r in records]
            data = wireproto.encode_response_chunk(out)
            self._wire_note("response_chunks", 1)
            self._wire_note("bytes_out", len(data))
            self._wire_sample("response", len(out))
            conn.write(data)

    def _shed_body(self, body: bytes) -> bytes:
        from ..webhook.policy import (
            FAIL_OPEN_ANNOTATION,
            FAIL_OPEN_SHED,
            SHED_CODE,
            SHED_MESSAGE,
            AdmissionResponse,
        )

        m = _UID_RE.search(body or b"")
        uid = m.group(1).decode("utf-8", "replace") if m else ""
        resp = AdmissionResponse(
            self.fail_open, SHED_MESSAGE, 200 if self.fail_open
            else SHED_CODE,
            annotations=(
                {FAIL_OPEN_ANNOTATION: FAIL_OPEN_SHED}
                if self.fail_open else None
            ),
        )
        return _envelope(resp.to_dict(uid=uid))

    # ---- worker side -----------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None or self._stop.is_set():
                return
            conn, records = item
            try:
                data = wireproto.encode_response_chunk(
                    self._process(records))
            except Exception:
                # chunk processing or framing failed (e.g. amplified
                # deny messages pushed the response payload over
                # MAX_PAYLOAD): the door MUST still hear back, or it
                # holds every request of this chunk until deadline
                # expiry — forever with no admission budget configured
                log.exception("wire chunk processing failed")
                data = self._failure_chunk(records)
            if data is not None:
                self._wire_note("response_chunks", 1)
                self._wire_note("bytes_out", len(data))
                self._wire_sample("response", len(records))
            loop = self._loop
            if loop is not None and not conn.closed:
                if data is None:
                    # even the fallback would not frame: close the
                    # connection so the door's _wire_client_lost
                    # retry/502 path answers the chunk's requests
                    loop.call_soon_threadsafe(
                        lambda c=conn: c.close(None))
                else:
                    loop.call_soon_threadsafe(lambda c=conn, d=data:
                                              c.write(d))

    def _failure_chunk(self, records: list) -> Optional[bytes]:
        """Best-effort per-record 500s when whole-chunk processing
        failed — the same 200-wrapped explicit-verdict shape the
        handle_many handler-defect fallback produces.  None when even
        this cannot be framed (the caller closes the connection)."""
        from ..webhook.policy import AdmissionResponse

        try:
            out = []
            for r in records:
                m = _UID_RE.search(r.body or b"")
                uid = m.group(1).decode("utf-8", "replace") if m else ""
                resp = AdmissionResponse(
                    False, "wire chunk processing failed", 500)
                out.append(wireproto.ResponseRecord(
                    r.req_id, 200, _envelope(resp.to_dict(uid=uid))))
            return wireproto.encode_response_chunk(out)
        except Exception:
            log.exception("wire failure-chunk fallback failed")
            return None

    def _process(self, records: list) -> List[wireproto.ResponseRecord]:
        out: List[Optional[wireproto.ResponseRecord]] = [None] * len(records)
        server = self.server
        stopping = bool(server is not None
                        and getattr(server, "_stopping", False))
        draining = bool(server is not None
                        and getattr(server, "_draining", False))
        budget_default = (
            self._deadline_budget_s if server is None
            else getattr(server, "deadline_budget_s", None)
        )
        batch: List[tuple] = []   # (pos, req, deadline, span)
        roots: dict = {}          # pos -> (rootctx, req)
        for pos, rec in enumerate(records):
            if stopping:
                out[pos] = wireproto.ResponseRecord(
                    rec.req_id, 503, b"shutting down")
                continue
            if draining:
                out[pos] = wireproto.ResponseRecord(
                    rec.req_id, 503, b"draining")
                continue
            if rec.path not in ("/v1/admit", "/v1/admitlabel"):
                out[pos] = wireproto.ResponseRecord(
                    rec.req_id, 404, b"not found")
                continue
            try:
                review = json.loads(rec.body or b"{}")
                req = review.get("request") or {}
                if not isinstance(req, dict):
                    raise TypeError(
                        "AdmissionReview request must be an "
                        f"object, got {type(req).__name__}"
                    )
            except Exception as e:  # malformed envelope
                log.exception("bad admission request")
                from ..webhook.policy import AdmissionResponse

                resp = AdmissionResponse(False, str(e), 500)
                out[pos] = wireproto.ResponseRecord(
                    rec.req_id, 200, _envelope(resp.to_dict(uid="")))
                continue
            budget = _deadline.effective_budget_s(
                budget_default,
                _deadline.parse_timeout_seconds(req),
                None if rec.deadline_ms is None else rec.deadline_ms / 1e3,
            )
            deadline = (
                None if budget is None else time.monotonic() + budget
            )
            rootctx = obstrace.root_span(
                "admission", traceparent=rec.traceparent or None,
                path=rec.path, uid=str(req.get("uid", "")),
            )
            roots[pos] = (rootctx.span, req)
            if rec.path == "/v1/admitlabel":
                # label admissions are rare control-plane traffic; they
                # keep the per-request lane
                resp = self._label_one(req, budget, rootctx.span)
                out[pos] = wireproto.ResponseRecord(
                    rec.req_id, 200,
                    _envelope(resp.to_dict(uid=req.get("uid", ""))))
                continue
            batch.append((pos, req, deadline, rootctx.span))
        if batch:
            try:
                resps = self.handler.handle_many(
                    [(req, dl, span) for _pos, req, dl, span in batch])
            except Exception as e:   # handler defect: per-chunk fallback
                log.exception("bad admission request")
                from ..webhook.policy import AdmissionResponse

                resps = [AdmissionResponse(False, str(e), 500)
                         for _ in batch]
            for (pos, req, _dl, span), resp in zip(batch, resps):
                span.set_attrs(allowed=resp.allowed, code=resp.code)
                out[pos] = wireproto.ResponseRecord(
                    records[pos].req_id, 200,
                    _envelope(resp.to_dict(uid=req.get("uid", ""))))
        for span, _req in roots.values():
            span.end()
        return out  # type: ignore[return-value]

    def _label_one(self, req: dict, budget: Optional[float], span):
        from ..webhook.policy import AdmissionResponse

        token = _deadline.push(budget) if budget is not None else None
        try:
            handler = self.label_handler
            if handler is None:
                return AdmissionResponse(True, "")
            with obstrace.use_span(span):
                resp = handler.handle(req)
            span.set_attrs(allowed=resp.allowed, code=resp.code)
            return resp
        except Exception as e:
            log.exception("bad admission request")
            return AdmissionResponse(False, str(e), 500)
        finally:
            if token is not None:
                _deadline.pop(token)
