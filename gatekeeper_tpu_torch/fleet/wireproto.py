"""Batched door↔replica wire protocol.

The event-loop serving edge does not speak HTTP between the front door
and the replicas.  Instead the door splices request bodies — verbatim,
never parsed — into length-prefixed *chunk frames*: one frame carries
every request the door accumulated in one event-loop tick for one
backend, so the replica-side listener hands the micro-batcher whole
chunks (one condition-variable acquisition for N requests) instead of
N one-request writes.  Responses travel back the same way, coalesced
into response chunks as they complete.

Frame layout (all integers network byte order)::

    MAGIC "GKW1" | kind u8 | count u16 | payload_len u32 | payload

Request record (kind=KIND_REQUEST), repeated ``count`` times::

    req_id u32 | deadline_ms f64 (NaN = no deadline; REMAINING budget
    at encode time) | path_len u16 | tp_len u16 | body_len u32
    | path | traceparent | body

``body`` is the AdmissionReview bytes exactly as the client sent them —
the door routes on headers plus a regex'd uid only, and the JSON is
parsed exactly once, at the replica (the byte-splice contract; the
framing tests hash-check it).

Response record (kind=KIND_RESPONSE)::

    req_id u32 | status u16 | body_len u32 | body

This module is PURE framing: no sockets, no threads — `encode_*` are
functions and :class:`FrameDecoder` is an incremental push parser, so
partial reads, pipelined frames sharing one buffer, and N-way split
recv() sequences are unit-testable without a listener.
"""

from __future__ import annotations

import math
import struct
from typing import List, NamedTuple, Optional, Tuple

MAGIC = b"GKW1"

KIND_REQUEST = 0
KIND_RESPONSE = 1

_HDR = struct.Struct("!4sBHI")           # magic, kind, count, payload_len
_REQ = struct.Struct("!IdHHI")           # req_id, deadline_ms, plen, tlen, blen
_RESP = struct.Struct("!IHI")            # req_id, status, blen

#: hard frame bound — an admission chunk larger than this is corruption
#: or abuse, mirroring the edge's 32MB body bound with chunk headroom
MAX_PAYLOAD = 64 * 1024 * 1024
MAX_RECORDS = 4096


class ProtocolError(ValueError):
    """The byte stream is not a well-formed frame sequence.  The
    connection carrying it cannot be resynchronized and must close."""


class RequestRecord(NamedTuple):
    req_id: int
    path: str
    body: bytes
    deadline_ms: Optional[float] = None   # REMAINING budget, ms
    traceparent: str = ""


class ResponseRecord(NamedTuple):
    req_id: int
    status: int
    body: bytes


def encode_request_chunk(records: List[RequestRecord]) -> bytes:
    """One request chunk frame.  ``deadline_ms`` is the budget REMAINING
    at encode time — the wire twin of the X-GK-Deadline-Ms header, so a
    replica re-enters its deadline with what is left of the caller's
    patience, never a fresh allowance."""
    if not 0 < len(records) <= MAX_RECORDS:
        raise ProtocolError(f"chunk of {len(records)} records")
    parts = []
    for r in records:
        path = r.path.encode("ascii", "replace")
        tp = r.traceparent.encode("ascii", "replace")
        dl = float("nan") if r.deadline_ms is None else float(r.deadline_ms)
        parts.append(_REQ.pack(r.req_id & 0xFFFFFFFF, dl, len(path),
                               len(tp), len(r.body)))
        parts.append(path)
        parts.append(tp)
        parts.append(r.body)
    payload = b"".join(parts)
    if len(payload) > MAX_PAYLOAD:
        raise ProtocolError(f"chunk payload {len(payload)}B over bound")
    return _HDR.pack(MAGIC, KIND_REQUEST, len(records), len(payload)) + payload


def encode_response_chunk(records: List[ResponseRecord]) -> bytes:
    if not 0 < len(records) <= MAX_RECORDS:
        raise ProtocolError(f"chunk of {len(records)} records")
    parts = []
    for r in records:
        parts.append(_RESP.pack(r.req_id & 0xFFFFFFFF, r.status & 0xFFFF,
                                len(r.body)))
        parts.append(r.body)
    payload = b"".join(parts)
    if len(payload) > MAX_PAYLOAD:
        raise ProtocolError(f"chunk payload {len(payload)}B over bound")
    return _HDR.pack(MAGIC, KIND_RESPONSE, len(records), len(payload)) + payload


def _decode_request_payload(payload: memoryview,
                            count: int) -> List[RequestRecord]:
    out = []
    off = 0
    for _ in range(count):
        if off + _REQ.size > len(payload):
            raise ProtocolError("request record truncated inside frame")
        req_id, dl, plen, tlen, blen = _REQ.unpack_from(payload, off)
        off += _REQ.size
        end = off + plen + tlen + blen
        if end > len(payload):
            raise ProtocolError("request record body overruns frame")
        path = bytes(payload[off:off + plen]).decode("ascii", "replace")
        off += plen
        tp = bytes(payload[off:off + tlen]).decode("ascii", "replace")
        off += tlen
        body = bytes(payload[off:off + blen])
        off += blen
        out.append(RequestRecord(
            req_id, path, body,
            deadline_ms=None if math.isnan(dl) else dl,
            traceparent=tp,
        ))
    if off != len(payload):
        raise ProtocolError(f"{len(payload) - off} stray bytes after the "
                            "last record in a request frame")
    return out


def _decode_response_payload(payload: memoryview,
                             count: int) -> List[ResponseRecord]:
    out = []
    off = 0
    for _ in range(count):
        if off + _RESP.size > len(payload):
            raise ProtocolError("response record truncated inside frame")
        req_id, status, blen = _RESP.unpack_from(payload, off)
        off += _RESP.size
        if off + blen > len(payload):
            raise ProtocolError("response record body overruns frame")
        out.append(ResponseRecord(req_id, status,
                                  bytes(payload[off:off + blen])))
        off += blen
    if off != len(payload):
        raise ProtocolError(f"{len(payload) - off} stray bytes after the "
                            "last record in a response frame")
    return out


class FrameDecoder:
    """Incremental frame parser: feed() bytes as they arrive off a
    socket (in any split — one byte at a time, several frames at once,
    a frame torn across N recv() calls) and get back every COMPLETE
    frame's records.  A malformed stream raises :class:`ProtocolError`;
    the caller must close the connection (there is no resync point in a
    length-prefixed stream that lied about its lengths)."""

    __slots__ = ("_buf",)

    def __init__(self):
        self._buf = bytearray()

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> List[Tuple[int, list]]:
        """-> [(kind, records), ...] for every frame completed by
        ``data`` (empty list while a frame is still partial)."""
        self._buf += data
        out: List[Tuple[int, list]] = []
        while True:
            if len(self._buf) < _HDR.size:
                return out
            magic, kind, count, plen = _HDR.unpack_from(self._buf, 0)
            if magic != MAGIC:
                raise ProtocolError(f"bad frame magic {magic!r}")
            if plen > MAX_PAYLOAD:
                raise ProtocolError(f"frame payload {plen}B over bound")
            if count > MAX_RECORDS:
                raise ProtocolError(f"frame of {count} records")
            if len(self._buf) < _HDR.size + plen:
                return out
            payload = memoryview(self._buf)[_HDR.size:_HDR.size + plen]
            if kind == KIND_REQUEST:
                records = _decode_request_payload(payload, count)
            elif kind == KIND_RESPONSE:
                records = _decode_response_payload(payload, count)
            else:
                raise ProtocolError(f"unknown frame kind {kind}")
            del payload
            del self._buf[:_HDR.size + plen]
            out.append((kind, records))
