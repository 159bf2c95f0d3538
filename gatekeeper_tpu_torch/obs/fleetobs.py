"""Fleet-wide observability plane: metrics federation and
cross-process trace assembly for the replica fleet (docs/fleet.md).

Two parent-side collectors, both driven by a live ``targets()`` callable
(the supervisor's or bench harness's current replica roster survives
restarts on fresh ephemeral ports):

- :class:`MetricsFederator` — scrapes every replica's Prometheus
  exporter (the ``metrics_port`` each replica announces in its ready
  line), injects a ``replica_id`` label into samples that do not already
  carry one, merges the families with the parent's own registry
  (front-door wire metrics, scrape-health gauges, fleet rollups) and
  renders ONE classic-format body for the front door's ``/metrics``.
  The classic byte discipline from holds: one HELP/TYPE header
  per family, no exemplars, no ``# EOF``
  (tools/check_observability.py verifies the federated output too).

  **Degraded, never blocked:** each scrape runs on its own bounded
  thread (``util.join_thread``); a replica that stops answering —
  including the seeded ``fleet.scrape_fail`` fault — keeps serving its
  last-known-good series **stale-marked** via
  ``fleet_scrape_ok{replica_id}=0`` and a growing
  ``fleet_scrape_age_seconds``, and a scrape still in flight is skipped
  (never doubled) on the next pass.

- :class:`TraceCollector` — fetches each replica's ``/debug/traces``
  ring (bounded per-target timeout), joins replica spans with the
  parent tracer's front-door wire traces **by trace_id**, and serves
  the assembled end-to-end view at ``/debug/fleet-traces?min_ms=`` on
  the shared debug router: one slow admission shows ``replica_wait`` on
  the wire and ``queue_wait``/``dispatch`` on the device in one entry.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from .. import faults
from .. import logging as gklog
from ..metrics.catalog import record_fleet_rollup, record_scrape
from ..metrics.exporter import render_prometheus
from ..metrics.views import Registry, global_registry
from ..util import join_thread
from . import trace as obstrace
from .debug import BadParam, _num, get_router

log = gklog.get("obs.fleetobs")

# targets() yields dicts: {"replica_id": str, "host": str, "port": int}
Targets = Callable[[], List[dict]]

_FAMILY_HEADER = re.compile(r"^# (HELP|TYPE) (\S+)(?: (.*))?$")
# the family whose samples the fleet rollup sums (admissions served)
_ROLLUP_FAMILY = "gatekeeper_request_count"


# ---- classic-format parsing / relabelling ----------------------------------


def parse_families(text: str) -> "OrderedDict[str, dict]":
    """Classic Prometheus text -> ordered {family: {help, type,
    samples}}.  Samples between two headers belong to the preceding
    family (histogram ``_bucket``/``_sum``/``_count`` lines included),
    which is exactly how this repo's exporter groups them."""
    fams: "OrderedDict[str, dict]" = OrderedDict()
    cur: Optional[dict] = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _FAMILY_HEADER.match(line)
            if m is None:
                continue  # foreign comment (a classic body has no others)
            kind, name, rest = m.group(1), m.group(2), m.group(3) or ""
            cur = fams.setdefault(
                name, {"help": None, "type": None, "samples": []}
            )
            cur["help" if kind == "HELP" else "type"] = rest
        else:
            if cur is None:
                name = re.split(r"[{ ]", line, 1)[0]
                cur = fams.setdefault(
                    name, {"help": None, "type": None, "samples": []}
                )
            cur["samples"].append(line)
    return fams


def split_sample(line: str) -> Tuple[str, Optional[str], str]:
    """One sample line -> (name, labels-or-None, value part).  The
    closing brace is found with quote/escape awareness: label VALUES may
    legally contain ``}`` (template names do)."""
    brace = line.find("{")
    space = line.find(" ")
    if brace == -1 or (space != -1 and space < brace):
        name, _, value = line.partition(" ")
        return name, None, value
    i = brace + 1
    in_quotes = False
    while i < len(line):
        c = line[i]
        if in_quotes:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_quotes = False
        elif c == '"':
            in_quotes = True
        elif c == "}":
            break
        i += 1
    return line[:brace], line[brace + 1:i], line[i + 1:].lstrip()


_RID_LABEL = re.compile(r'(?:^|,)replica_id="')


def label_sample(line: str, replica_id: str) -> str:
    """Inject ``replica_id`` into one sample line unless the replica
    already stamped its own (the replica_id-tagged series of —
    their values are authoritative)."""
    name, labels, value = split_sample(line)
    rid = replica_id.replace("\\", "\\\\").replace('"', '\\"')
    if labels is None:
        return f'{name}{{replica_id="{rid}"}} {value}'
    if _RID_LABEL.search(labels):
        return line
    sep = "," if labels else ""
    return f'{name}{{replica_id="{rid}"{sep}{labels}}} {value}'


def _merge_parsed(
    fams: "OrderedDict[str, dict]",
    parsed: List[Tuple[str, "OrderedDict[str, dict]"]],
) -> "OrderedDict[str, dict]":
    """Merge already-parsed replica family maps into ``fams`` in place:
    one header per family, remote samples relabelled."""
    for replica_id, rfams in parsed:
        for name, fam in rfams.items():
            tgt = fams.setdefault(
                name, {"help": fam["help"], "type": fam["type"],
                       "samples": []}
            )
            if tgt["help"] is None:
                tgt["help"] = fam["help"]
            if tgt["type"] is None:
                tgt["type"] = fam["type"]
            tgt["samples"].extend(
                label_sample(s, replica_id) for s in fam["samples"]
            )
    return fams


def merge_families(
    local_text: str, remote: List[Tuple[str, str]]
) -> "OrderedDict[str, dict]":
    """Merge the parent's own exposition with N (replica_id, body)
    scrapes: one header per family, remote samples relabelled."""
    return _merge_parsed(
        parse_families(local_text),
        [(rid, parse_families(body)) for rid, body in remote],
    )


def render_families(fams: "OrderedDict[str, dict]") -> str:
    lines: List[str] = []
    for name in sorted(fams):
        fam = fams[name]
        if fam["help"] is not None:
            lines.append(f"# HELP {name} {fam['help']}")
        if fam["type"] is not None:
            lines.append(f"# TYPE {name} {fam['type']}")
        lines.extend(fam["samples"])
    return "\n".join(lines) + "\n"


def _http_get(host: str, port: int, path: str,
              timeout_s: float) -> Tuple[int, bytes]:
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


# ---- metrics federation -----------------------------------------------------


class _ScrapeState:
    __slots__ = ("body", "last_ok_at", "ok", "ever", "first_seen")

    def __init__(self):
        self.body: Optional[str] = None   # last-known-good exposition
        self.last_ok_at = 0.0             # monotonic
        self.ok = False                   # most recent pass succeeded
        self.ever = False                 # scraped successfully at least once
        # staleness anchor for a replica that has NEVER scraped: age
        # must grow from first sight, not sit at 0 (the most-broken
        # replica would otherwise rank as the freshest)
        self.first_seen = time.monotonic()


class MetricsFederator:
    """Scrape-and-merge federation for the fleet's ``/metrics``
    (module docstring).  ``render()`` is called per scrape of the
    federated endpoint; every per-target fetch is bounded by
    ``timeout_s`` and runs off the caller's thread."""

    def __init__(self, targets: Targets, timeout_s: float = 1.0,
                 registry: Optional[Registry] = None):
        self.targets = targets
        self.timeout_s = float(timeout_s)
        self.registry = registry or global_registry()
        self._mu = threading.Lock()
        self._state: Dict[str, _ScrapeState] = {}
        self._inflight: Dict[str, float] = {}  # rid -> scrape start (mono)

    # -- scraping ------------------------------------------------------------

    def _scrape_one(self, target: dict, token: float):
        rid = str(target.get("replica_id", ""))
        try:
            if faults.ENABLED:
                faults.fire(faults.SCRAPE_FAIL, replica_id=rid)
            status, body = _http_get(
                target.get("host", "127.0.0.1"), int(target["port"]),
                "/metrics", self.timeout_s,
            )
            if status != 200:
                raise RuntimeError(f"scrape status {status}")
            text = body.decode("utf-8", "replace")
            with self._mu:
                if self._inflight.get(rid) != token:
                    # we were EVICTED (drip-fed past the cap) and a
                    # successor owns this target now: our data predates
                    # its scrape — writing it would serve older samples
                    # marked freshest (counters would appear to regress)
                    return
                st = self._state.setdefault(rid, _ScrapeState())
                st.body = text
                st.last_ok_at = time.monotonic()
                st.ok = st.ever = True
        except Exception as e:
            with self._mu:
                if self._inflight.get(rid) != token:
                    return  # evicted: the successor's verdict stands
                st = self._state.setdefault(rid, _ScrapeState())
                st.ok = False
            log.debug("scrape of replica %s failed (%s: %s); serving "
                      "stale-marked series", rid, type(e).__name__, e)
        finally:
            with self._mu:
                # pop only OUR OWN registration: a scrape abandoned by
                # the eviction cap may have been superseded — its late
                # completion must not evict the successor's entry
                if self._inflight.get(rid) == token:
                    self._inflight.pop(rid, None)

    def refresh(self) -> List[Tuple[str, _ScrapeState, bool]]:
        """One scrape pass over the current targets; returns
        [(replica_id, state, in_roster)] — roster targets in order,
        then any remembered replica that left the roster (health-only,
        marked not-ok; see below).

        A target with a scrape already in flight is not scraped again
        (never two threads behind one wedge).  Whether that in-flight
        scrape marks the target stale depends on its AGE: a recent one
        is just a concurrent render racing this one (two Prometheus
        servers scraping the door must not stale-mark a healthy fleet),
        while one older than the scrape budget is genuinely wedged and
        flips ``ok`` off."""
        try:
            targets = list(self.targets() or ())
        except Exception:
            log.exception("federation targets() failed; serving cache")
            targets = []
        budget = self.timeout_s + 0.5
        # a scrape thread can outlive the socket timeout indefinitely
        # (an exporter drip-feeding bytes resets the timeout per recv);
        # past this cap its registration is EVICTED so the target gets
        # re-scraped — otherwise a recovered replica would serve
        # stale-marked forever behind one immortal thread
        evict_after = 4 * budget
        now = time.monotonic()
        threads: List[Tuple[str, threading.Thread]] = []
        order: List[str] = []
        for t in targets:
            rid = str(t.get("replica_id", ""))
            order.append(rid)
            with self._mu:
                started = self._inflight.get(rid)
                if started is not None and now - started <= evict_after:
                    if now - started > budget:
                        # wedged past its budget: honestly stale
                        self._state.setdefault(
                            rid, _ScrapeState()).ok = False
                    continue
                self._inflight[rid] = now
            th = threading.Thread(
                target=self._scrape_one, args=(t, now), daemon=True,
                name=f"gk-scrape-{rid}",
            )
            th.start()
            threads.append((rid, th))
        # bounded by ONE shared deadline, not per-target: the threads
        # run concurrently, so a fleet of wedged exporters costs one
        # budget total — never N budgets — before /metrics answers
        deadline = time.monotonic() + budget
        for rid, th in threads:
            remaining = deadline - time.monotonic()
            if remaining > 0:
                join_thread(th, remaining, f"scrape {rid}")
            elif th.is_alive():
                log.debug("scrape %s abandoned at the shared deadline",
                          rid)
        with self._mu:
            scraped = [
                (rid, self._state.setdefault(rid, _ScrapeState()), True)
                for rid in order
            ]
            # replicas that LEFT the roster (quarantined, scaled down):
            # their health gauges must keep updating (ok=0, age still
            # growing) rather than freeze at whatever was last recorded
            # — a frozen ok=1 would report the most-broken replica as
            # healthy forever.  Only the health gauges follow them;
            # their cached series leave the merged body.  Bounded: one
            # _ScrapeState per replica id ever seen.
            roster = set(order)
            for rid, st in self._state.items():
                if rid not in roster:
                    st.ok = False
                    scraped.append((rid, st, False))
        return scraped

    # -- rendering -----------------------------------------------------------

    @staticmethod
    def _rollup(parsed: List[Tuple[str, "OrderedDict[str, dict]"]]
                ) -> float:
        total = 0.0
        for _rid, fams in parsed:
            fam = fams.get(_ROLLUP_FAMILY)
            if not fam:
                continue
            for line in fam["samples"]:
                _name, _labels, value = split_sample(line)
                try:
                    total += float(value.split()[0])
                except (ValueError, IndexError):
                    pass  # an unparsable foreign sample never fails /metrics
        return total

    def render(self) -> str:
        """The federated classic-format body: scrape, stale-mark,
        rollup, merge, render."""
        scraped = self.refresh()
        now = time.monotonic()
        # each replica body is parsed ONCE; the rollup and the merge
        # both consume the parsed form
        parsed: List[Tuple[str, "OrderedDict[str, dict]"]] = []
        n_ok = 0
        for rid, st, in_roster in scraped:
            # staleness age: since the last good scrape — or, for a
            # replica that has NEVER answered, since it was first seen
            # (so the age still grows instead of pinning at 0)
            age = now - (st.last_ok_at if st.ever else st.first_seen)
            record_scrape(rid, st.ok, max(age, 0.0))
            if st.ok:
                n_ok += 1
            if in_roster and st.body is not None:
                # stale-marked, not missing: a wedged replica's last-
                # known-good series keep serving under scrape_ok=0
                parsed.append((rid, parse_families(st.body)))
        record_fleet_rollup(n_ok, self._rollup(parsed))
        local = render_prometheus(self.registry)
        return render_families(_merge_parsed(
            parse_families(local), parsed
        ))


# ---- cross-process trace assembly ------------------------------------------


class TraceCollector:
    """Join front-door wire traces with replica traces by trace_id
    (module docstring).  ``install()`` registers
    ``/debug/fleet-traces`` on the shared debug router."""

    # per-replica ring fetch floor: the replica ring default (256) —
    # fetching less would silently drop joinable halves
    FETCH_LIMIT = 256

    def __init__(self, targets: Targets, timeout_s: float = 1.0,
                 tracer: Optional[obstrace.Tracer] = None):
        self.targets = targets
        self.timeout_s = float(timeout_s)
        self.tracer = tracer or obstrace.get_tracer()
        # replicas size their rings from GK_TRACE_BUFFER (shared env in
        # a fleet): fetch in step with it, or widened rings would serve
        # joinable halves this collector never asks for
        try:
            ring = int(os.environ.get("GK_TRACE_BUFFER", "256"))
        except ValueError:
            ring = 256
        self.fetch_limit = max(self.FETCH_LIMIT, ring)

    def _fetch_remote(self) -> Tuple[Dict[str, List[Tuple[str, dict]]],
                                     List[str]]:
        """-> ({trace_id: [(replica_id, trace_dict)]}, failed replica
        ids).  Concurrent bounded fetches joined against ONE shared
        deadline (the MetricsFederator.refresh pattern): a fleet of
        wedged replicas costs one timeout total on /debug/fleet-traces
        — exactly the situation an operator queries traces in —
        never N timeouts."""
        by_id: Dict[str, List[Tuple[str, dict]]] = {}
        failed: List[str] = []
        try:
            targets = list(self.targets() or ())
        except Exception:
            log.exception("trace-collector targets() failed")
            return by_id, ["<targets>"]
        results: Dict[str, Optional[list]] = {}
        res_mu = threading.Lock()

        def fetch(t: dict, rid: str):
            try:
                status, body = _http_get(
                    t.get("host", "127.0.0.1"), int(t["port"]),
                    f"/debug/traces?limit={self.fetch_limit}",
                    self.timeout_s,
                )
                if status != 200:
                    raise RuntimeError(f"status {status}")
                traces = json.loads(body).get("traces", ())
                with res_mu:
                    results[rid] = list(traces)
            except Exception as e:
                log.debug("trace fetch from replica %s failed (%s: %s)",
                          rid, type(e).__name__, e)

        threads = []
        order = []
        for t in targets:
            rid = str(t.get("replica_id", ""))
            order.append(rid)
            th = threading.Thread(target=fetch, args=(t, rid),
                                  daemon=True, name=f"gk-traces-{rid}")
            th.start()
            threads.append(th)
        deadline = time.monotonic() + self.timeout_s + 0.5
        for rid, th in zip(order, threads):
            remaining = deadline - time.monotonic()
            if remaining > 0:
                join_thread(th, remaining, f"trace fetch {rid}")
        with res_mu:
            snap = dict(results)
        for rid in order:
            traces = snap.get(rid)
            if traces is None:
                failed.append(rid)
                continue
            for tr in traces:
                by_id.setdefault(tr.get("trace_id", ""), []).append(
                    (rid, tr)
                )
        return by_id, failed

    def assemble(self, min_ms: float = 0.0,
                 limit: Optional[int] = None) -> dict:
        """The /debug/fleet-traces payload: one entry per front-door
        wire trace (newest first, filtered by wire duration), each
        carrying the front-door spans AND every replica's spans that
        share its trace_id, every span tagged with its ``process``."""
        wire = self.tracer.traces(min_ms=min_ms, limit=limit)
        remote, failed = self._fetch_remote()
        out = []
        for t in wire:
            spans = [dict(s, process="frontdoor") for s in t["spans"]]
            replicas = []
            for rid, rt in remote.get(t["trace_id"], ()):
                replicas.append(rid)
                spans.extend(dict(s, process=rid)
                             for s in rt.get("spans", ()))
            entry = {
                "trace_id": t["trace_id"],
                "root": t.get("root", ""),
                "start_ts": t.get("start_ts"),
                "duration_ms": t.get("duration_ms", 0.0),
                "processes": ["frontdoor"] + replicas,
                "stage_breakdown": obstrace.stage_breakdown(
                    {"spans": spans}
                ),
                "wire_stage_breakdown": obstrace.stage_breakdown(t),
                "spans": spans,
            }
            out.append(entry)
        return {"traces": out, "failed_replicas": failed}

    def install(self):
        """Serve /debug/fleet-traces on the shared router (both the
        front door's listener and any exporter in this process)."""
        collector = self

        def _handler(q) -> tuple:
            min_ms = _num(q, "min_ms", float, 0.0)
            limit = _num(q, "limit", int, None)
            if limit is not None and limit < 1:
                raise BadParam("limit must be a positive integer")
            return (
                200, "application/json",
                json.dumps(collector.assemble(min_ms, limit)).encode(),
            )

        get_router().register("/debug/fleet-traces", _handler)
        return self
