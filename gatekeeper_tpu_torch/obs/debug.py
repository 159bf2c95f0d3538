"""Shared /debug/* router: one routing + query-parsing surface
serving the debug introspection endpoints on BOTH HTTP front ends — the
webhook server (webhook/server.py) and the standalone metrics exporter
(metrics/exporter.py) — so audit-only deployments (no webhook) still get
the full debug surface.

Endpoints (docs/tracing.md):

  /debug/traces?min_ms=&limit=   recent completed traces (obs/trace.py)
  /debug/stacks                  live thread-stack dump
  /debug/costs?top=              per-template cost attribution (obs/costs.py)
  /debug/slo                     SLO burn-rate status (obs/slo.py)
  /debug/profilez?reset=         collapsed-stack CPU profile (obs/profiler.py)
  /debug/routez?limit=           route-decision ledger: recent pricing
                                 decisions, live calibration, per-shape
                                 tier-win table (obs/routeledger.py)
  /debug/compilez?limit=         compile/device telemetry: provenance
                                 mix, epoch lag, device memory
                                 (obs/compilestats.py)
  /debug/flightrecz?limit=&dump= flight-recorder event ring; dump=1 also
                                 writes the on-disk artifact
                                 (obs/flightrec.py)
  /debug/decisionz?limit=&verdict= recent decision records (ring mirror)
                                 + recorder stats; verdict filters by
                                 decision class (obs/decisionlog.py)
  /debug/connz?limit=            per-connection introspection across the
                                 registered event edges — age, bytes
                                 in/out, write backlog, pipelining depth,
                                 parser state, idle time; worst backlog
                                 first (obs/reactorobs.py)
  /debug/fleet-traces?min_ms=    assembled cross-process traces — present
                                 only where a fleet TraceCollector is
                                 installed (obs/fleetobs.py)

Contracts this module owns:

- Query params are parsed HERE, hardened: a non-numeric ``min_ms``,
  ``limit`` or ``top`` yields a JSON 400 naming the parameter — never a
  500 traceback (a curious operator with a typo must get a usable error).
- Unknown /debug paths yield a JSON 404 listing the available endpoints.
- A handler defect yields a JSON 500 (message only, no traceback body).

Handlers return ``(status_code, content_type, body_bytes)``; servers only
transport.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

DEBUG_PREFIX = "/debug/"

Response = Tuple[int, str, bytes]


class BadParam(ValueError):
    """A malformed query parameter (the JSON-400 contract)."""


def _json(code: int, payload: dict) -> Response:
    return code, "application/json", json.dumps(payload).encode()


def _num(q: Dict[str, List[str]], name: str, cast, default):
    """One numeric query param; BadParam on garbage, default when
    absent."""
    raw = q.get(name, [None])[0]
    if raw is None:
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        raise BadParam(f"{name} must be numeric") from None


class DebugRouter:
    """Path -> handler(query_dict) -> Response."""

    def __init__(self):
        self._routes: Dict[str, Callable[[Dict[str, List[str]]], Response]] = {
            "/debug/traces": self._traces,
            "/debug/stacks": self._stacks,
            "/debug/costs": self._costs,
            "/debug/slo": self._slo,
            "/debug/profilez": self._profilez,
            "/debug/routez": self._routez,
            "/debug/compilez": self._compilez,
            "/debug/flightrecz": self._flightrecz,
            "/debug/decisionz": self._decisionz,
            "/debug/connz": self._connz,
        }

    def endpoints(self) -> List[str]:
        return sorted(self._routes)

    def register(self, path: str,
                 handler: Callable[[Dict[str, List[str]]], Response]):
        self._routes[path] = handler

    # ---- dispatch ----------------------------------------------------------

    def handle(self, path: str, query: str = "") -> Response:
        """Route one GET.  ``path`` must be the bare path (no query
        string); returns a complete response triple for any /debug path,
        including errors."""
        handler = self._routes.get(path)
        if handler is None:
            return _json(404, {
                "error": "unknown debug path",
                "path": path,
                "available": self.endpoints(),
            })
        try:
            q = parse_qs(query or "")
        except ValueError:
            q = {}
        try:
            return handler(q)
        except BadParam as e:
            return _json(400, {"error": str(e)})
        except Exception as e:  # defect: JSON 500, never a traceback body
            return _json(500, {"error": f"{type(e).__name__}: {e}"})

    # ---- handlers ----------------------------------------------------------

    def _traces(self, q) -> Response:
        from . import trace as obstrace

        min_ms = _num(q, "min_ms", float, 0.0)
        limit = _num(q, "limit", int, None)
        return (
            200, "application/json",
            obstrace.traces_json(min_ms=min_ms, limit=limit).encode(),
        )

    def _stacks(self, q) -> Response:
        from . import trace as obstrace

        return _json(200, obstrace.dump_stacks())

    def _costs(self, q) -> Response:
        from . import costs as obscosts

        top = _num(q, "top", int, None)
        if top is not None and top < 1:
            raise BadParam("top must be a positive integer")
        return _json(200, obscosts.get_ledger().snapshot(top=top))

    def _slo(self, q) -> Response:
        from . import slo as obsslo

        return _json(200, obsslo.get_engine().evaluate())

    def _profilez(self, q) -> Response:
        from . import profiler as obsprofiler

        reset = _num(q, "reset", int, 0)
        body = obsprofiler.get_profiler().collapsed(reset=bool(reset))
        return 200, "text/plain; charset=utf-8", body.encode()

    def _routez(self, q) -> Response:
        from . import routeledger

        limit = _num(q, "limit", int, None)
        if limit is not None and limit < 0:
            raise BadParam("limit must be a non-negative integer")
        ledger = routeledger.get_active()
        if ledger is None:
            # no driver constructed (interp-only deployment): an empty,
            # well-formed payload — not an error
            return _json(200, {
                "decisions": [], "tier_wins": [], "counts": {},
                "calibration": None, "flips": 0, "enabled": False,
            })
        return _json(200, ledger.snapshot(limit=limit))

    def _compilez(self, q) -> Response:
        from . import compilestats

        limit = _num(q, "limit", int, None)
        if limit is not None and limit < 0:
            raise BadParam("limit must be a non-negative integer")
        return _json(200, compilestats.get_stats().snapshot(limit=limit))

    def _flightrecz(self, q) -> Response:
        from . import flightrec

        limit = _num(q, "limit", int, None)
        if limit is not None and limit < 0:
            raise BadParam("limit must be a non-negative integer")
        do_dump = _num(q, "dump", int, 0)
        rec = flightrec.get_recorder()
        payload = {"events": rec.events(limit=limit)}
        if do_dump:
            payload["dumped_to"] = rec.dump("debug_endpoint")
        return _json(200, payload)


    def _decisionz(self, q) -> Response:
        from . import decisionlog

        limit = _num(q, "limit", int, None)
        if limit is not None and limit < 0:
            raise BadParam("limit must be a non-negative integer")
        verdict = q.get("verdict", [None])[0]
        if verdict is not None and verdict not in decisionlog.CLASSES:
            raise BadParam(
                "verdict must be one of "
                + ", ".join(decisionlog.CLASSES)
            )
        return _json(200, decisionlog.get_log().snapshot(
            limit=limit, verdict=verdict,
        ))

    def _connz(self, q) -> Response:
        from . import reactorobs

        limit = _num(q, "limit", int, None)
        if limit is not None and limit < 0:
            raise BadParam("limit must be a non-negative integer")
        # no registered edge (threaded-door deployment): an empty,
        # well-formed payload — not an error
        return _json(200, reactorobs.connz_snapshot(limit=limit))


_ROUTER = DebugRouter()


def get_router() -> DebugRouter:
    return _ROUTER
