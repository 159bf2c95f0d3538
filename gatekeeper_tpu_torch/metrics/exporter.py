"""Prometheus/OpenMetrics exposition + standalone metrics HTTP server.

The reference exports views through a Prometheus exporter serving on its
own HTTP listener at --prometheus-port 8888 (pkg/metrics/exporter.go:14-15,
prometheus_exporter.go).  Same here, with two extensions:

- **Content negotiation.**  An ``Accept`` header containing
  ``application/openmetrics-text`` selects the OpenMetrics rendering:
  counter families drop/regain the ``_total`` sample suffix per the spec,
  histogram bucket lines carry trace exemplars
  (``# {trace_id="..."} value ts`` — the link from a hot bucket to its
  /debug/traces entry), and the body terminates with ``# EOF``.  The
  classic text format (the default) is byte-identical to what it always
  was: no exemplars, no terminator.
- **Debug surface.**  ``/debug/*`` routes through the shared DebugRouter
  (obs/debug.py), so audit-only deployments — which run no webhook
  listener — still serve /debug/traces, /debug/costs and /debug/slo.

``collect_hooks`` run before each scrape renders (guarded): the cost
ledger and SLO engine refresh their gauges there, so scraped values are
current without any background refresher thread.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from .views import (
    AGG_COUNT,
    AGG_DISTRIBUTION,
    AGG_LAST_VALUE,
    AGG_SUM,
    DistributionData,
    Registry,
    global_registry,
)

NAMESPACE = "gatekeeper"  # metric name prefix, as the reference's exporter

CONTENT_TYPE_TEXT = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(keys, values) -> str:
    pairs = [f'{k}="{_escape(v)}"' for k, v in zip(keys, values) if v != ""]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _kind(aggregation: str) -> str:
    return {
        AGG_COUNT: "counter",
        AGG_SUM: "counter",
        AGG_LAST_VALUE: "gauge",
        AGG_DISTRIBUTION: "histogram",
    }[aggregation]


def render_prometheus(registry: Optional[Registry] = None) -> str:
    registry = registry or global_registry()
    lines = []
    for view, rows in sorted(registry.snapshot(), key=lambda s: s[0].name):
        full = f"{NAMESPACE}_{view.name}"
        kind = _kind(view.aggregation)
        lines.append(f"# HELP {full} {view.description}")
        lines.append(f"# TYPE {full} {kind}")
        for tag_values in sorted(rows):
            val = rows[tag_values]
            label_str = _labels(view.tag_keys, tag_values)
            if isinstance(val, DistributionData):
                cumulative = 0
                for bound, n in zip(view.buckets, val.bucket_counts):
                    cumulative += n
                    le = _labels(
                        view.tag_keys + ("le",),
                        tag_values + (_fmt(bound),),
                    )
                    lines.append(f"{full}_bucket{le} {cumulative}")
                le = _labels(view.tag_keys + ("le",), tag_values + ("+Inf",))
                lines.append(f"{full}_bucket{le} {val.count}")
                lines.append(f"{full}_sum{label_str} {_fmt(val.sum)}")
                lines.append(f"{full}_count{label_str} {val.count}")
            else:
                lines.append(f"{full}{label_str} {_fmt(float(val))}")
    return "\n".join(lines) + "\n"


def _exemplar_suffix(ex) -> str:
    """OpenMetrics exemplar: `` # {labels} value timestamp``."""
    return (
        f' # {{trace_id="{_escape(ex.trace_id)}"}} '
        f"{_fmt(ex.value)} {ex.ts:.3f}"
    )


def render_openmetrics(registry: Optional[Registry] = None) -> str:
    """OpenMetrics 1.0 text rendering: counter families named without the
    ``_total`` suffix (samples carry it), per-bucket exemplars on
    histograms, ``# EOF`` terminator."""
    registry = registry or global_registry()
    lines = []
    for view, rows in sorted(registry.snapshot(), key=lambda s: s[0].name):
        kind = _kind(view.aggregation)
        family = f"{NAMESPACE}_{view.name}"
        if kind == "counter" and family.endswith("_total"):
            family = family[: -len("_total")]
        lines.append(f"# HELP {family} {view.description}")
        lines.append(f"# TYPE {family} {kind}")
        for tag_values in sorted(rows):
            val = rows[tag_values]
            label_str = _labels(view.tag_keys, tag_values)
            if isinstance(val, DistributionData):
                cumulative = 0
                for i, (bound, n) in enumerate(
                    zip(view.buckets, val.bucket_counts)
                ):
                    cumulative += n
                    le = _labels(
                        view.tag_keys + ("le",),
                        tag_values + (_fmt(bound),),
                    )
                    ex = val.exemplars.get(i)
                    suffix = _exemplar_suffix(ex) if ex else ""
                    lines.append(
                        f"{family}_bucket{le} {cumulative}{suffix}"
                    )
                le = _labels(view.tag_keys + ("le",), tag_values + ("+Inf",))
                ex = val.exemplars.get(len(view.buckets))
                suffix = _exemplar_suffix(ex) if ex else ""
                lines.append(f"{family}_bucket{le} {val.count}{suffix}")
                lines.append(f"{family}_sum{label_str} {_fmt(val.sum)}")
                lines.append(f"{family}_count{label_str} {val.count}")
            elif kind == "counter":
                lines.append(
                    f"{family}_total{label_str} {_fmt(float(val))}"
                )
            else:
                lines.append(f"{family}{label_str} {_fmt(float(val))}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def negotiate(accept_header: Optional[str]):
    """-> (render_fn, content_type) from an Accept header value."""
    if accept_header and "application/openmetrics-text" in accept_header:
        return render_openmetrics, CONTENT_TYPE_OPENMETRICS
    return render_prometheus, CONTENT_TYPE_TEXT


class _Handler(BaseHTTPRequestHandler):
    registry: Registry = None
    collect_hooks: List[Callable[[Registry], None]] = ()

    def _send(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path.startswith("/debug/"):
            from ..obs.debug import get_router

            self._send(*get_router().handle(path, query))
            return
        if path not in ("/metrics", "/"):
            self._send(404, "text/plain", b"not found")
            return
        for hook in self.collect_hooks:
            try:
                hook(self.registry)
            except Exception:  # a hook defect must never break the scrape
                from .catalog import record_dropped

                record_dropped(
                    "collect_hook:"
                    + getattr(hook, "__name__", repr(hook))
                )
        render, ctype = negotiate(self.headers.get("Accept"))
        self._send(200, ctype, render(self.registry).encode())

    def log_message(self, *args):  # quiet
        pass


class MetricsExporter:
    """Background Prometheus endpoint (reference runner in exporter.go:40-57)."""

    def __init__(
        self,
        port: int = 8888,
        registry: Optional[Registry] = None,
        host: str = "0.0.0.0",
        collect_hooks: Optional[List[Callable[[Registry], None]]] = None,
    ):
        self.port = port
        self.host = host
        self.registry = registry or global_registry()
        self.collect_hooks = list(collect_hooks or ())
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def add_collect_hook(self, hook: Callable[[Registry], None]):
        self.collect_hooks.append(hook)

    def start(self):
        # idempotent: a double start must REPLACE the previous listener,
        # not leak it — the old socket otherwise still holds the port the
        # new bind needs (parity with WebhookServer.start()); shutdown()
        # only when serve_forever is actually running
        if self._server is not None:
            if self._thread is not None and self._thread.is_alive():
                self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None
        handler = type(
            "Handler", (_Handler,),
            {"registry": self.registry, "collect_hooks": self.collect_hooks},
        )
        try:
            self._server = ThreadingHTTPServer((self.host, self.port), handler)
        except OSError as e:
            # port-in-use (or bad bind address) must surface as a clear,
            # actionable startup error, not a bare traceback — the
            # operator's fix is a flag change, not a code change
            raise RuntimeError(
                f"metrics exporter cannot bind {self.host}:{self.port}: {e} "
                "(is another process — or a previous exporter — holding "
                "--prometheus-port?)"
            ) from e
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics", daemon=True
        )
        self._thread.start()

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None
