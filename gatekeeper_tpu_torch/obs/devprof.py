"""The device profiler behind ``--jax-profile-port``: the port's
counterpart of ``jax.profiler.start_server``.

``DeviceProfileServer(port, device)`` is a debug listener that records
nothing until asked.  Its endpoints:

- ``GET /capture?ms=N`` (1 <= N <= 10,000, default 1,000) runs one
  ``torch.profiler`` session (Kineto; on ``cuda`` over CUPTI, which
  records every kernel of the process whichever library launched it) for
  N ms and answers a Chrome trace (open it in Perfetto) holding Kineto's
  events, the port's spans that overlap the window on the same clock
  (one row per thread), and a ``gk_summary`` object: the window, each
  hand-written kernel's (K1-K10) count and total and median device us,
  the device's busy ms and busy share, the five longest gaps between
  device operations with the spans open over each, and the busy device
  time inside the spans of each name.  At most ``MAX_EVENTS`` events are
  kept; the summary counts the rest as dropped.
- ``GET /memory``: on ``cuda`` the card's free and total bytes and the
  caching allocator's allocated and reserved bytes, current and peak (the
  JAX server's HBM view); on ``cpu`` no card figures.
- ``GET /status``: whether a capture's window is open (``capturing``)
  and whether a profiler session holds the process (``busy``).

No fallback hides the card: on ``cuda`` a capture whose window saw the
port's launch counters move but whose trace holds no CUDA kernel event
fails (500, with the reason), as does one where CUPTI is unavailable.
One profiler session runs in a process at a time: a second session
started from another thread stops the first one's under it (with torch
2.13 the process then crashed), so every capture, and any other code of
the process that profiles, holds ``exclusive()``; a capture while it is
held answers 409.

The spans' clock is ``time.perf_counter``; Kineto's is its own.  The
capture thread marks the window with a ``record_function`` (its bounds in
Kineto's clock) and, at each end, records a few zero-length marks, each
between two ``perf_counter`` reads: a mark's Kineto time lies inside its
bracket, so the tightest bracket gives the offset that shifts every span
(``alignment_error_us`` is that bracket's half-width; a bracket that a
thread switch widened, the GIL's 5 ms, is passed over).  While the
window runs, the same thread samples the tracer's
active span of each thread every ``SAMPLE_S``, which places each span on
the row of its thread (a span never seen active takes its nearest
ancestor's or descendant's).  Idle, the server adds nothing to any
request: the kernels' wrappers carry no profiler code.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..util import close_listener
from . import trace as obstrace

#: each kernel library's number (PERF.md section 6); a library's
#: launchers (device._SIGNATURES) and every __global__ function of its
#: source count under it: K7's merge under K7, K8's two modes under K8,
#: K9's sweep, review and delta modes under K9
K_OF_LIBRARY = {
    "match": "K1", "strpred": "K2", "setcount": "K3", "reduction": "K4",
    "delta": "K5", "scatter": "K6", "joinkeys": "K7", "joinlookup": "K8",
    "program": "K9", "packbits": "K10",
}
KERNELS = tuple(f"K{i}" for i in range(1, 11))
MS_DEFAULT, MS_MAX = 1000, 10_000
#: events kept in one answer (Kineto's and the spans'); the rest dropped
MAX_EVENTS = 200_000
#: the active-span sampling period inside the window
SAMPLE_S = 0.001
#: gaps listed, and spans named over each
TOP_GAPS, GAP_SPANS = 5, 8
#: span names whose busy device time the summary lists
TOP_SPAN_NAMES = 24
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "gk_capture_window"
#: the clock marks: CLOCK_MARKS zero-length record_functions at each end
#: of the window, each bracketed by two perf_counter reads
CLOCK = "gk_clock"
CLOCK_MARKS = 4
SPAN_PID = "gatekeeper spans"

_SESSION = threading.Lock()
#: set while a capture's window runs (after the profiler started)
_WINDOW = threading.Event()
_GLOBAL_QUALIFIERS = {"const", "volatile", "__restrict__",
                      "__grid_constant__", "struct", "unsigned", "signed"}
_DECL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*"
    r"\(([^)]*)\)", re.S)


class ProfilerBusy(RuntimeError):
    """Another profiler session holds the process."""


class CaptureFailed(RuntimeError):
    """A capture that must not be answered with a trace (the reason)."""


@contextlib.contextmanager
def exclusive():
    """Hold the process's one profiler session; ProfilerBusy when another
    holds it.  Every torch.profiler session of the process takes it."""
    if not _SESSION.acquire(blocking=False):
        raise ProfilerBusy("another profiler session is active")
    try:
        yield
    finally:
        _SESSION.release()


def busy() -> bool:
    return _SESSION.locked()


# ---- kernel symbols --------------------------------------------------------


def _first_param_type(params: str) -> str:
    first = params.split(",")[0]
    words = [w for w in re.findall(r"\w+", first)
             if w not in _GLOBAL_QUALIFIERS]
    # the last word is the parameter's name
    return words[-2] if len(words) >= 2 else (words[0] if words else "")


def kernel_symbols(src_dir: Optional[str] = None) -> Dict[Tuple[str, str],
                                                          str]:
    """(kernel function, its first parameter's type) -> K number, for
    every ``__global__`` function of each launcher's library source (read
    from ``kernels/``; the launchers are ``device._SIGNATURES``')."""
    from .. import device

    src_dir = src_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "kernels")
    out: Dict[Tuple[str, str], str] = {}
    for library in sorted({sig[0] for sig in device._SIGNATURES.values()}):
        k = K_OF_LIBRARY[library]
        with open(os.path.join(src_dir, f"{library}.cu")) as f:
            text = f.read()
        found = _DECL.findall(text)
        if not found:
            raise ValueError(f"{library}.cu defines no __global__ function")
        for name, params in found:
            out[(name, _first_param_type(params))] = k
    return out


def classify(name: str, symbols: Dict[Tuple[str, str], str]) -> Optional[str]:
    """The K number of a CUDA kernel event's name (demangled, or mangled
    where Kineto could not demangle it), or None for a kernel the port
    did not write.  A function name two sources share (K7's and K8's
    ``table_kernel``) is told apart by its first parameter's type."""
    mangled = name.startswith("_Z")

    def find(word: str, text: str, call: bool) -> int:
        if mangled:
            i = text.find(f"{len(word)}{word}")
            return -1 if i < 0 else i + len(str(len(word))) + len(word)
        m = re.search(r"(?<![\w])" + word + (r"\s*[<(]" if call
                                             else r"(?!\w)"), text)
        return m.end() if m else -1

    hits: Dict[str, list] = {}
    for (fn, ptype), k in symbols.items():
        end = find(fn, name, True)
        if end >= 0:
            hits.setdefault(fn, []).append((ptype, k, end))
    for cands in hits.values():
        if len(cands) == 1:
            return cands[0][1]
        for ptype, k, end in cands:
            if find(ptype, name[end:], False) >= 0:
                return k
    return None


# ---- the summary -----------------------------------------------------------


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(merged: List[List[float]], a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged
               if x < b and y > a)


def summarize(events: List[dict], window: Tuple[float, float],
              spans: List[dict], symbols, launches: Dict[str, int]) -> dict:
    """gk_summary of a capture: ``events`` Kineto's, ``window`` (start,
    end) in its microseconds, ``spans`` the port's as trace events on the
    same clock, ``launches`` the port's launch counters' deltas."""
    w0, w1 = window
    per_k: Dict[str, List[float]] = {k: [] for k in KERNELS}
    device = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        a, d = float(e["ts"]), float(e.get("dur", 0.0))
        device.append((a, a + d))
        k = classify(e.get("name", ""), symbols) if cat == "kernel" \
            else None
        if k:
            per_k[k].append(d)
    busy = _merge([(max(a, w0), min(b, w1)) for a, b in device
                   if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in busy)
    win_us = max(w1 - w0, 1e-9)
    gaps = sorted(((c - b, b, c) for (_a, b), (c, _d) in zip(busy, busy[1:])),
                  reverse=True)
    span_iv = [(s["ts"], s["ts"] + s["dur"], s) for s in spans]
    top_gaps = []
    for length, a, b in gaps[:TOP_GAPS]:
        open_over = sorted(
            ((min(b, y) - max(a, x), s) for x, y, s in span_iv
             if x < b and y > a), key=lambda t: -t[0])[:GAP_SPANS]
        top_gaps.append({
            "start_ms": (a - w0) / 1e3, "ms": length / 1e3,
            "spans": [{"name": s["name"], "thread": s["args"]["thread"],
                       "overlap_ms": ov / 1e3} for ov, s in open_over]})
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for x, y, s in span_iv:
        by_name.setdefault(s["name"], []).append((x, y))
    span_rows = []
    for name, ivs in by_name.items():
        merged = _merge(ivs)
        open_us = sum(b - a for a, b in merged)
        dev_us = sum(_overlap(busy, a, b) for a, b in merged)
        span_rows.append({"name": name, "count": len(ivs),
                          "ms": open_us / 1e3, "device_busy_ms": dev_us / 1e3,
                          "busy_share": dev_us / open_us if open_us else 0.0})
    span_rows.sort(key=lambda r: -r["ms"])
    return {
        "window_ms": win_us / 1e3,
        "kernels": {k: {"count": len(v), "total_us": sum(v),
                        "median_us": statistics.median(v) if v else None}
                    for k, v in per_k.items()},
        "device_events": len(device),
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / win_us,
        "gaps": top_gaps,
        "spans": span_rows[:TOP_SPAN_NAMES],
        "launches": {k: v for k, v in launches.items() if v},
    }


# ---- the capture ----------------------------------------------------------


def _launch_counts() -> Dict[str, int]:
    from .. import device

    return dict(device.launches)


def _window(seconds: float) -> Tuple[Dict[str, int], Dict[int, tuple]]:
    """Wait out the window on this thread -> (span id -> the thread ident
    it was seen active on, thread ident -> (native id, name))."""
    owner: Dict[str, int] = {}
    names: Dict[int, tuple] = {}
    deadline = time.perf_counter() + seconds
    while True:
        for ident, sp in obstrace.active_spans().items():
            owner.setdefault(sp.span_id, ident)
            if ident not in names:  # a request thread may end in the window
                names.update((t.ident, (t.native_id, t.name))
                             for t in threading.enumerate())
        left = deadline - time.perf_counter()
        if left <= 0:
            return owner, names
        time.sleep(min(SAMPLE_S, left))


def _span_events(p0: float, p1: float, offset_us: float,
                 owner: Dict[str, int], names: Dict[int, tuple]) -> List[dict]:
    """The port's finished spans overlapping [p0, p1] (perf_counter s) as
    Chrome trace events on Kineto's clock, one row (tid) per thread."""
    seen: Dict[str, dict] = {}
    for tr in obstrace.get_tracer().traces():
        for s in tr["spans"]:
            stop = s["start"] + s["duration_ms"] / 1e3
            if s["span_id"] not in seen and s["start"] < p1 and stop > p0:
                seen[s["span_id"]] = s
    children: Dict[str, List[str]] = {}
    for sid, s in seen.items():
        children.setdefault(s.get("parent_id") or "", []).append(sid)

    def thread_of(sid: str):
        cur = seen.get(sid)
        while cur is not None:  # the nearest ancestor seen active
            if cur["span_id"] in owner:
                return owner[cur["span_id"]]
            cur = seen.get(cur.get("parent_id") or "")
        todo = list(children.get(sid, ()))
        while todo:  # else the first descendant seen active
            c = todo.pop(0)
            if c in owner:
                return owner[c]
            todo.extend(children.get(c, ()))
        return None

    names = {**{t.ident: (t.native_id, t.name)
                for t in threading.enumerate()}, **names}
    out = []
    rows = {}
    for sid, s in seen.items():
        ident = thread_of(sid)
        if ident is None:
            tid, tname = 0, "unattributed"
        else:
            tid, tname = names.get(ident, (ident, f"thread {ident}"))
        rows[tid] = tname
        args = {"thread": tname, "trace_id": s["trace_id"],
                "span_id": sid, **(s.get("attrs") or {})}
        out.append({"name": s["name"], "cat": "gk_span", "ph": "X",
                    "ts": s["start"] * 1e6 + offset_us,
                    "dur": s["duration_ms"] * 1e3, "pid": SPAN_PID,
                    "tid": tid, "args": args})
    out.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    meta = [{"name": "thread_name", "ph": "M", "pid": SPAN_PID, "tid": tid,
             "args": {"name": tname}} for tid, tname in sorted(rows.items())]
    return meta + out


def _clock_marks(record_function) -> List[Tuple[float, float]]:
    """CLOCK_MARKS zero-length marks -> each one's bracket (perf_counter
    s before and after its start)."""
    out = []
    for _ in range(CLOCK_MARKS):
        a = time.perf_counter()
        with record_function(CLOCK):
            b = time.perf_counter()
        out.append((a, b))
    return out


def _default_profiler(activities):
    from torch.profiler import profile

    return profile(activities=activities)


def capture(ms: int, device: str, profiler_factory=None) -> dict:
    """One capture of ``ms`` milliseconds -> the Chrome trace (a dict).
    Raises ProfilerBusy, or CaptureFailed with the reason."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    on_card = str(device).startswith("cuda")
    activities = [ProfilerActivity.CPU]
    if on_card:
        if ProfilerActivity.CUDA not in \
                torch.profiler.supported_activities():
            raise CaptureFailed("torch.profiler cannot trace CUDA here "
                                "(no CUPTI): no CPU-only trace is served "
                                "in its place")
        activities.append(ProfilerActivity.CUDA)
    if torch.autograd._profiler_enabled():
        raise ProfilerBusy("this thread already runs a profiler session")
    factory = profiler_factory or _default_profiler
    with exclusive():
        t_start = time.perf_counter()
        prof = factory(activities)
        with prof:
            start_ms = (time.perf_counter() - t_start) * 1e3
            before = _launch_counts()
            brackets = _clock_marks(record_function)
            p0 = time.perf_counter()
            _WINDOW.set()
            try:
                with record_function(MARKER):
                    owner, names = _window(ms / 1e3)
            finally:
                _WINDOW.clear()
            p1 = time.perf_counter()
            brackets += _clock_marks(record_function)
            after = _launch_counts()
        t_export = time.perf_counter()
        fd, path = tempfile.mkstemp(prefix="gk-capture-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
    launches = {k: after[k] - before.get(k, 0) for k in after}
    events = trace.get("traceEvents") or []
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    moved = sum(launches.values())
    if on_card and moved and not kernels:
        raise CaptureFailed(
            f"the port launched {moved} kernels in the window "
            f"({ {k: v for k, v in launches.items() if v} }) but the trace "
            f"holds no CUDA kernel event: CUPTI recorded nothing, and no "
            f"CPU-only trace is served in its place")
    marks = [e for e in events if e.get("name") == MARKER
             and e.get("ph") == "X"]
    if not marks:
        raise CaptureFailed(f"the trace holds no {MARKER} marker: its "
                            f"clock cannot be aligned with the spans'")
    m = marks[0]
    clocks = sorted((e for e in events if e.get("name") == CLOCK
                     and e.get("ph") == "X"), key=lambda e: float(e["ts"]))
    if len(clocks) != len(brackets):
        raise CaptureFailed(f"the trace holds {len(clocks)} of the "
                            f"{len(brackets)} clock marks")
    # the mark whose bracket is tightest: its Kineto time minus the
    # bracket's middle is the offset, to within half the bracket
    err_us, offset = min(((b - a) * 1e6 / 2, float(e["ts"]) - (a + b) * 1e6 / 2)
                         for e, (a, b) in zip(clocks, brackets))
    window = (float(m["ts"]), float(m["ts"]) + float(m["dur"]))
    spans = _span_events(p0, p1, offset, owner, names)
    span_x = [s for s in spans if s.get("ph") == "X"]
    summary = summarize(events, window, span_x, kernel_symbols(), launches)
    # the device's events, the marker, the rows' names and the spans
    # first; the host's events fill what room is left
    first = [e for e in events if e.get("ph") == "M" or e is m or
             e.get("cat") in DEVICE_CATS]
    keep = {id(e) for e in first}
    ordered = first + spans + [e for e in events if id(e) not in keep]
    trace["traceEvents"] = ordered[:MAX_EVENTS]
    summary.update({
        "device": str(device), "ms_asked": ms,
        "profiler_start_ms": start_ms,
        "export_ms": (time.perf_counter() - t_export) * 1e3,
        "alignment_error_us": err_us,
        "events": len(ordered),
        "events_dropped": max(len(ordered) - MAX_EVENTS, 0),
        "span_events": len(span_x),
    })
    if on_card:
        summary["device_name"] = torch.cuda.get_device_name(
            torch.device(device))
    trace["gk_summary"] = summary
    return trace


def memory(device: str) -> dict:
    """The card's memory: its free and total bytes and the caching
    allocator's allocated and reserved bytes, current and peak."""
    import torch

    if not str(device).startswith("cuda"):
        return {"device": str(device), "card": None,
                "reason": "the evaluation runs on the CPU: no card memory"}
    dev = torch.device(device)
    free, total = torch.cuda.mem_get_info(dev)
    st = torch.cuda.memory_stats(dev)
    return {
        "device": str(dev), "card": torch.cuda.get_device_name(dev),
        "free_bytes": free, "total_bytes": total,
        **{f"{kind}_bytes": {
            "current": st.get(f"{kind}_bytes.all.current", 0),
            "peak": st.get(f"{kind}_bytes.all.peak", 0)}
           for kind in ("allocated", "reserved")},
    }


# ---- the listener ---------------------------------------------------------


class DeviceProfileServer:
    """The ``--jax-profile-port`` listener (see the module docstring)."""

    def __init__(self, port: int, device="cuda", profiler_factory=None):
        self.port = port
        self.device = str(device)
        self.profiler_factory = profiler_factory
        self.captures = 0
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def answer(self, path: str) -> Tuple[int, dict]:
        url = urlparse(path)
        if url.path == "/memory":
            return 200, memory(self.device)
        if url.path == "/status":
            return 200, {"device": self.device,
                         "capturing": _WINDOW.is_set(), "busy": busy(),
                         "captures": self.captures}
        if url.path != "/capture":
            return 404, {"error": "not found: /capture, /memory, /status"}
        raw = parse_qs(url.query).get("ms", [str(MS_DEFAULT)])[-1]
        try:
            ms = int(raw)
        except ValueError:
            ms = -1
        if not 1 <= ms <= MS_MAX:
            return 400, {"error": f"ms must be an integer in 1..{MS_MAX}, "
                                  f"not {raw!r}"}
        try:
            out = capture(ms, self.device, self.profiler_factory)
        except ProfilerBusy as e:
            return 409, {"error": str(e)}
        except Exception as e:  # the listener never takes the App down
            return 500, {"error": f"{type(e).__name__}: {e}"}
        self.captures += 1
        return 200, out

    def start(self):
        # idempotent, like ProfileServer.start (no leaked listener thread
        # or socket on a double start)
        close_listener(self._server, self._thread)
        self._server = None
        self._thread = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                code, payload = outer.answer(self.path)
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="device-profile",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        close_listener(self._server, self._thread)
        self._server = None
        self._thread = None
