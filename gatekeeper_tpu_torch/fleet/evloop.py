"""Selectors-based reactor for the serving edge.

One thread, one ``selectors.DefaultSelector``, zero blocking socket
calls: every socket on the loop is non-blocking, reads drain into
per-connection buffers, and writes go through :meth:`Conn.write` —
opportunistic ``send()`` first, remainder buffered and flushed when the
kernel signals writability.  ``sendall`` is banned on loop threads (the
``blocking-socket-in-loop`` gklint rule enforces this module-wide).

The pieces here are deliberately transport-only so both edge endpoints
share them:

* :class:`EventLoop` — selector + wake pipe + monotonic timers +
  ``call_soon_threadsafe`` for worker threads posting results back.
* :class:`Conn` — buffered non-blocking connection base class; subclass
  and implement ``on_bytes``/``on_closed``.
* :class:`HttpRequestParser` — incremental HTTP/1.1 request parser:
  pipelined requests sharing one buffer, bodies split across N recvs,
  and the slow-client bounds (oversized Content-Length surfaces
  as 413 the moment headers complete, without reading the body).
"""

from __future__ import annotations

import heapq
import itertools
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .. import logging as gklog
from ..util import join_thread

log = gklog.get("fleet.evloop")

__all__ = ["EventLoop", "Conn", "HttpRequestParser", "HttpError",
           "http_response"]

_RECV_SIZE = 262144


class EventLoop:
    """Single-threaded reactor.  All selector mutation and all Conn
    I/O happens on the loop thread; other threads may only enter via
    :meth:`call_soon_threadsafe` (a socketpair wake keeps the select()
    honest).  Timers are monotonic-clock heap entries fired between
    select rounds; tick hooks run once per round after I/O and timers —
    the door uses one to coalesce every request buffered during the
    round into a single wire chunk per backend."""

    def __init__(self, name: str = "evloop"):
        self._name = name
        self._sel = selectors.DefaultSelector()
        self._rsock, self._wsock = socket.socketpair()
        self._rsock.setblocking(False)
        self._wsock.setblocking(False)
        self._sel.register(self._rsock, selectors.EVENT_READ, self._on_wake)
        self._pending: deque = deque()
        self._plock = threading.Lock()
        self._timers: list = []
        self._seq = itertools.count()
        self._tick_hooks: List[Callable[[], None]] = []
        self._stop_flag = False
        self._thread: Optional[threading.Thread] = None
        self._woken = False
        # optional reactor telemetry sink (obs/reactorobs.py): when
        # None, the loop body pays only `is not None` branches — a bare
        # EventLoop stays as cheap as before the flight deck existed
        self._telem = None

    # -- lifecycle ---------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return   # idempotent: the reactor is already running
        self._thread = threading.Thread(target=self._run,
                                        name=self._name, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        self._stop_flag = True
        self._wake()
        join_thread(self._thread, timeout, f"event loop {self._name}")
        self._thread = None
        telem = self._telem
        if telem is not None:
            # the final tick's partially-batched observes must reach the
            # registry — a shutdown that silently drops them understates
            # exactly the last (often most interesting) window
            telem.flush()

    def set_telemetry(self, sink) -> None:
        """Attach a reactor telemetry sink (obs/reactorobs.py
        ReactorTelemetry, or anything with its ``slow_s`` / ``cur`` /
        ``note_drift`` / ``slow`` / ``tick`` / ``flush`` surface).
        Pass None to detach.  The sink's methods run ON the loop
        thread and must never block or raise."""
        self._telem = sink

    @property
    def telemetry(self):
        return self._telem

    @property
    def thread_ident(self) -> Optional[int]:
        """The reactor thread's ident while running (the watchdog's
        sys._current_frames key), else None."""
        t = self._thread
        return t.ident if t is not None else None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def on_thread(self) -> bool:
        return threading.current_thread() is self._thread

    # -- cross-thread entry ------------------------------------------
    def _wake(self) -> None:
        try:
            self._wsock.send(b"\0")
        except (BlockingIOError, OSError):
            pass   # wake buffer full ⇒ the loop is already scheduled

    def _on_wake(self, mask: int) -> None:
        try:
            while self._rsock.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass

    def call_soon_threadsafe(self, fn: Callable[[], None]) -> None:
        """Schedule ``fn()`` on the loop thread (worker threads posting
        completed responses back use this)."""
        with self._plock:
            self._pending.append(fn)
        self._wake()

    # -- timers (loop thread only) -----------------------------------
    def call_later(self, delay_s: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._timers,
                       (time.monotonic() + delay_s, next(self._seq), fn))

    # -- selector (loop thread only) ---------------------------------
    def register(self, sock, events: int, cb) -> None:
        self._sel.register(sock, events, cb)

    def modify(self, sock, events: int, cb) -> None:
        self._sel.modify(sock, events, cb)

    def unregister(self, sock) -> None:
        self._sel.unregister(sock)

    def add_tick_hook(self, fn: Callable[[], None]) -> None:
        self._tick_hooks.append(fn)

    # -- the reactor -------------------------------------------------
    def _run(self) -> None:
        # When a telemetry sink is attached, each tick splits into
        # select-wait vs. callback-work, every callback dispatch sets
        # the sink's `cur` breadcrumb (the cross-thread watchdog reads
        # it to name what the loop is stuck inside), over-threshold
        # callbacks go to slow-callback attribution, and timer pops
        # report their wheel drift.  Sink methods are internally
        # guarded; only tick() (which flushes to the registry) gets a
        # loop-side net.  Without a sink every added line is an
        # `is not None` branch.
        sel = self._sel
        perf = time.perf_counter
        try:
            while not self._stop_flag:
                telem = self._telem
                timeout = None
                if self._timers:
                    timeout = max(0.0, self._timers[0][0] - time.monotonic())
                t0 = perf() if telem is not None else 0.0
                events = sel.select(timeout)
                t1 = perf() if telem is not None else 0.0
                ncb = 0
                for key, mask in events:
                    cb = key.data
                    if telem is not None:
                        c0 = perf()
                        telem.cur = (cb, "io", c0)
                    try:
                        cb(mask)
                    except Exception:
                        # a dead conn must not kill the loop; the conn's
                        # own close/error path answers the client
                        log.exception("event-loop I/O callback failed")
                    if telem is not None:
                        telem.cur = None
                        c1 = perf()
                        ncb += 1
                        if c1 - c0 >= telem.slow_s:
                            telem.slow(cb, "io", c1 - c0)
                now = time.monotonic()
                while self._timers and self._timers[0][0] <= now:
                    due, _, fn = heapq.heappop(self._timers)
                    if telem is not None:
                        telem.note_drift(now - due)
                        c0 = perf()
                        telem.cur = (fn, "timer", c0)
                    try:
                        fn()
                    except Exception:
                        log.exception("event-loop timer callback failed")
                    if telem is not None:
                        telem.cur = None
                        c1 = perf()
                        ncb += 1
                        if c1 - c0 >= telem.slow_s:
                            telem.slow(fn, "timer", c1 - c0)
                if self._pending:
                    with self._plock:
                        todo, self._pending = self._pending, deque()
                    for fn in todo:
                        if telem is not None:
                            c0 = perf()
                            telem.cur = (fn, "posted", c0)
                        try:
                            fn()
                        except Exception:
                            log.exception("event-loop posted callback "
                                          "failed")
                        if telem is not None:
                            telem.cur = None
                            c1 = perf()
                            ncb += 1
                            if c1 - c0 >= telem.slow_s:
                                telem.slow(fn, "posted", c1 - c0)
                for hook in self._tick_hooks:
                    if telem is not None:
                        c0 = perf()
                        telem.cur = (hook, "tick_hook", c0)
                    try:
                        hook()
                    except Exception:
                        log.exception("event-loop tick hook failed")
                    if telem is not None:
                        telem.cur = None
                        c1 = perf()
                        if c1 - c0 >= telem.slow_s:
                            telem.slow(hook, "tick_hook", c1 - c0)
                if telem is not None:
                    t2 = perf()
                    try:
                        telem.tick(t1 - t0, t2 - t0, ncb, t2)
                    except Exception:
                        log.exception("event-loop telemetry tick failed")
        finally:
            for key in list(sel.get_map().values()):
                try:
                    sel.unregister(key.fileobj)
                # gklint: disable=swallowed-exception -- best-effort
                # teardown of an already-stopping selector: the fd may
                # have been unregistered by a racing close
                except Exception:
                    pass
            sel.close()
            self._rsock.close()
            self._wsock.close()


class Conn:
    """Non-blocking buffered connection on an :class:`EventLoop`.

    Subclasses implement ``on_bytes(data)`` (called with each recv'd
    slab) and ``on_closed(exc)`` (exactly once, on EOF/error/close).
    ``write()`` attempts an immediate ``send`` and buffers any
    remainder, toggling EVENT_WRITE only while a backlog exists — the
    common case stays a single syscall with no selector churn."""

    def __init__(self, loop: EventLoop, sock: socket.socket):
        self.loop = loop
        self.sock = sock
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._wbuf: deque = deque()
        self._wlen = 0
        self._want_write = False
        self.closed = False
        self.created = time.monotonic()
        self.last_activity = self.created
        self.bytes_in = 0
        self.bytes_out = 0
        loop.register(sock, selectors.EVENT_READ, self._on_event)

    # -- subclass interface ------------------------------------------
    def on_bytes(self, data: bytes) -> None:
        raise NotImplementedError

    def on_closed(self, exc: Optional[BaseException]) -> None:
        pass

    def on_writable(self) -> None:
        """Called after the write backlog fully drains."""

    @property
    def write_backlog(self) -> int:
        return self._wlen

    # -- events ------------------------------------------------------
    def _on_event(self, mask: int) -> None:
        if mask & selectors.EVENT_READ:
            self._readable()
        if not self.closed and mask & selectors.EVENT_WRITE:
            self._writable()

    def _readable(self) -> None:
        try:
            data = self.sock.recv(_RECV_SIZE)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self.close(e)
            return
        if not data:
            self.close(None)
            return
        self.bytes_in += len(data)
        self.last_activity = time.monotonic()
        try:
            self.on_bytes(data)
        except Exception as e:
            self.close(e)

    def write(self, data: bytes) -> None:
        if self.closed or not data:
            return
        if not self._wbuf:
            try:
                n = self.sock.send(data)
            except (BlockingIOError, InterruptedError):
                n = 0
            except OSError as e:
                self.close(e)
                return
            self.bytes_out += n
            if n == len(data):
                return
            data = data[n:]
        self._wbuf.append(data)
        self._wlen += len(data)
        self._set_want_write(True)

    def _writable(self) -> None:
        while self._wbuf:
            head = self._wbuf[0]
            try:
                n = self.sock.send(head)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self.close(e)
                return
            self.bytes_out += n
            self._wlen -= n
            if n < len(head):
                self._wbuf[0] = head[n:]
                return
            self._wbuf.popleft()
        self._set_want_write(False)
        self.on_writable()

    def _set_want_write(self, want: bool) -> None:
        if want == self._want_write or self.closed:
            return
        self._want_write = want
        events = selectors.EVENT_READ
        if want:
            events |= selectors.EVENT_WRITE
        try:
            self.loop.modify(self.sock, events, self._on_event)
        except (KeyError, ValueError, OSError):
            pass

    def close(self, exc: Optional[BaseException] = None) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.loop.unregister(self.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        try:
            self.on_closed(exc)
        except Exception:
            log.exception("on_closed hook failed")


class HttpError(Exception):
    """Malformed or over-bound request; carries the HTTP status to
    answer with before the connection closes."""

    def __init__(self, code: int, reason: str, message: str = ""):
        super().__init__(message or reason)
        self.code = code
        self.reason = reason
        self.message = message or reason


_STATE_HEADERS = 0
_STATE_BODY = 1

#: hard bound on the request line + headers block
MAX_HEADER_BYTES = 65536


class HttpRequestParser:
    """Incremental HTTP/1.1 request parser for one connection.

    ``feed(data, now)`` returns every request COMPLETED by ``data`` as
    ``(method, target, headers, body, t_start, t_headers, t_body)`` —
    the three timestamps drive the wire stage clock (`accept` =
    first-byte→headers-complete, `read_body` = headers→body-complete)
    without any per-request syscalls.  Header names are lower-cased;
    duplicate headers keep the last value (matching http.client on the
    old edge).  Oversized Content-Length raises 413 at headers-complete
    so the body is never read; a missing length on POST is treated as
    zero; chunked uploads get 411 (the old door never decoded them
    either)."""

    __slots__ = ("_max_body", "_buf", "_state", "_need", "_cur",
                 "_head_memo", "t_start", "t_headers")

    #: per-connection parsed-head memo bound: a well-behaved client
    #: reuses one header block per connection, so pipelined requests hit
    #: a dict lookup instead of a full parse; a header-churning client
    #: just re-parses (the memo resets rather than grows)
    HEAD_MEMO_MAX = 8

    def __init__(self, max_body: int):
        self._max_body = max_body
        self._buf = bytearray()
        self._state = _STATE_HEADERS
        self._need = 0
        self._cur: Optional[Tuple[str, str, Dict[str, str]]] = None
        self._head_memo: Dict[bytes, tuple] = {}  # head -> (_cur, need)
        self.t_start: Optional[float] = None
        self.t_headers: Optional[float] = None

    @property
    def idle(self) -> bool:
        """No partially-received request buffered."""
        return self._state == _STATE_HEADERS and not self._buf

    @property
    def mid_body(self) -> bool:
        return self._state == _STATE_BODY

    def feed(self, data: bytes, now: Optional[float] = None):
        # timestamps are perf_counter anchors — they feed the wire stage
        # clock and root_span(start=...), which are perf_counter-based
        if now is None:
            now = time.perf_counter()
        self._buf += data
        out = []
        while True:
            if self._state == _STATE_HEADERS:
                if not self._buf:
                    return out
                if self.t_start is None:
                    self.t_start = now
                idx = self._buf.find(b"\r\n\r\n")
                if idx < 0:
                    if len(self._buf) > MAX_HEADER_BYTES:
                        e = HttpError(431, "Request Header Fields Too "
                                           "Large")
                        e.completed = out
                        raise e
                    return out
                head = bytes(self._buf[:idx])
                memo = self._head_memo.get(head)
                if memo is not None:
                    self._cur, self._need = memo
                else:
                    try:
                        self._parse_head(head)
                    except HttpError as e:
                        # pipelined requests parsed before the bad one
                        # must still be answered (in order) before the
                        # refusal
                        e.completed = out
                        raise
                    if len(self._head_memo) >= self.HEAD_MEMO_MAX:
                        self._head_memo.clear()
                    self._head_memo[head] = (self._cur, self._need)
                del self._buf[:idx + 4]
                self.t_headers = now
                self._state = _STATE_BODY
            if len(self._buf) < self._need:
                return out
            method, target, headers = self._cur  # type: ignore[misc]
            body = bytes(self._buf[:self._need])
            del self._buf[:self._need]
            out.append((method, target, headers, body,
                        self.t_start, self.t_headers, now))
            self._cur = None
            self._need = 0
            self._state = _STATE_HEADERS
            self.t_start = None
            self.t_headers = None

    def _parse_head(self, head: bytes) -> None:
        try:
            text = head.decode("latin-1")
        except UnicodeDecodeError:          # pragma: no cover — latin-1 total
            raise HttpError(400, "Bad Request", "undecodable header block")
        lines = text.split("\r\n")
        parts = lines[0].split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise HttpError(400, "Bad Request",
                            f"malformed request line {lines[0]!r}")
        method, target = parts[0], parts[1]
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if not ln:
                continue
            k, sep, v = ln.partition(":")
            if not sep:
                raise HttpError(400, "Bad Request",
                                f"malformed header line {ln!r}")
            headers[k.strip().lower()] = v.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise HttpError(411, "Length Required",
                            "chunked uploads are not accepted")
        cl = headers.get("content-length", "0" if method != "GET" else "0")
        try:
            need = int(cl or "0")
            if need < 0:
                raise ValueError
        except ValueError:
            raise HttpError(400, "Bad Request",
                            f"bad content length {cl!r}")
        if need > self._max_body:
            raise HttpError(413, "Payload Too Large",
                            f"{need} byte body over {self._max_body} bound")
        self._cur = (method, target, headers)
        self._need = need


def http_response(code: int, reason: str, ctype: str, body: bytes,
                  extra_headers: Tuple[Tuple[str, str], ...] = (),
                  close: bool = False) -> bytes:
    """Serialize one HTTP/1.1 response (keep-alive unless ``close``)."""
    lines = [f"HTTP/1.1 {code} {reason}",
             f"Content-Type: {ctype}",
             f"Content-Length: {len(body)}"]
    for k, v in extra_headers:
        lines.append(f"{k}: {v}")
    lines.append("Connection: close" if close else "Connection: keep-alive")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body
