"""Decision log: durable verdict provenance.

PRs 11 and 13 made the wire path and the engine legible; this module
makes the system's *decisions* durable.  Every admission verdict — and
every audit sweep's violation TRANSITIONS (new/resolved deltas, never
the full set) — lands in a bounded in-process queue a background writer
flushes into NDJSON segments, so a denied AdmissionReview survives the
trace ring's rotation and the archive doubles as a differential-replay
corpus (tools/replay_decisions.py).

Design constraints (docs/decision-logs.md is the operator contract):

- **Non-blocking**: ``record_admission`` runs on the admission hot path.
  It builds one dict, applies the head-sampling decision, and appends to
  a bounded queue under one lock — file I/O happens only on the writer
  thread.  A full queue SHEDS the record with a counted drop
  (``decision_log_dropped_total{reason="queue_full"}``); it never blocks
  and never raises into the caller (the record sites are guarded per the
  telemetry contract, metrics/catalog.py RECORD_DROPS).
- **Head sampling with always-keep classes**: under ``sample_rate`` < 1
  only ``allow`` verdicts are sampled out, deterministically (a
  counter-rollover keeps exactly the configured fraction).  Denials,
  sheds, deadline expiries, fail-open/closed errors, decisions taken
  under a breaker/brownout override and slow requests
  (``latency >= slow_ms``) are ALWAYS kept — the records an audit or
  post-mortem needs must survive any sampling configuration.
- **Durability discipline**: records append to a hidden ``.open`` temp
  file; segments become visible ONLY via an atomic rename on rotation
  (size/time bounded), so a reader never sees a torn segment.  Bounded
  retention prunes this replica's own oldest segments; in a shared
  fleet directory each replica writes (and prunes) only its
  ``decisions-<replica_id>-*`` files.
- **Tamper evidence (optional)**: with ``seal=True`` every line carries
  a ``sig`` — an HMAC chain under the shared seal key (util/seal.py,
  ``GK_SEAL_KEY``) over the previous line's sig + the record's canonical
  JSON.  ``verify_segment`` recomputes the chain; an edited, reordered
  or truncated-then-extended line fails it.  Whole-segment deletion is
  visible through the gap in the records' per-process ``seq``.
- **Field masking**: ``mask_fields`` dot-paths (e.g.
  ``request.userInfo``) are replaced before serialization; a masked
  record says so (``masked`` lists the paths) so the replay tool skips
  it instead of reporting phantom drift.

The in-memory ring mirror (bounded) serves ``/debug/decisionz`` even
with no directory configured, mirroring the flight recorder's contract.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .. import logging as gklog
from ..metrics.catalog import (
    record_decision_dropped,
    record_decision_record,
    record_decision_segment,
)
from ..util import join_thread, replica_id
# the BUILD-STABLE seal: a decision archive is source data replayed
# against later engines, so its chain must verify across builds
# (util/seal.py stable_seal; GK_SEAL_KEY still takes priority)
from ..util.seal import secure_makedirs, stable_seal as seal_hmac
from . import routeledger
from . import trace as obstrace

log = gklog.get("obs.decisionlog")

# ---- decision taxonomy (docs/decision-logs.md documents each class) ---------

CLASS_ALLOW = "allow"        # request admitted by policy
CLASS_DENY = "deny"          # denied by policy (or gk-resource validation)
CLASS_SHED = "shed"          # refused by the overload plane
CLASS_EXPIRED = "expired"    # admission deadline budget exhausted
CLASS_ERROR = "error"        # internal error (fail-open or fail-closed)

#: every class an admission record may carry — tools/check_observability.py
#: asserts each is documented in docs/decision-logs.md
CLASSES = (CLASS_ALLOW, CLASS_DENY, CLASS_SHED, CLASS_EXPIRED, CLASS_ERROR)

#: classes that bypass head sampling: the records an audit trail exists
#: for must survive any sampling configuration
ALWAYS_KEEP = (CLASS_DENY, CLASS_SHED, CLASS_EXPIRED, CLASS_ERROR)

#: route-ledger reasons that force always-keep even on an allow: a
#: decision taken under a degraded router is incident evidence
DEGRADED_ROUTE_REASONS = ("breaker_open", "brownout_pin", "device_failed")

#: record kinds
KIND_ADMISSION = "admission"
KIND_AUDIT_TRANSITION = "audit_transition"

#: the stable admission-record schema — every field ``record_admission``
#: may emit; tools/check_observability.py asserts each is documented in
#: docs/decision-logs.md (the record-schema table)
RECORD_FIELDS = (
    "t", "seq", "kind", "class", "uid", "trace_id", "replica_id",
    "verdict", "message_sha256", "templates", "constraints", "route",
    "latency_ms", "deadline_budget_ms", "fail_open", "brownout_level",
    "request", "masked", "transition", "constraint", "resource",
    "audit_id", "dropped_new", "dropped_resolved",
)

MASK_MARKER = "**masked**"

#: audit transitions recorded per sweep before the overflow summary —
#: a first sweep on a large cluster is all-new and must not evict the
#: whole queue
TRANSITIONS_MAX_PER_SWEEP = 2048

_DEFAULT_QUEUE = 4096
_DEFAULT_RING = 256
_DEFAULT_SEGMENT_BYTES = 4 * 1024 * 1024
_DEFAULT_SEGMENT_S = 60.0
_DEFAULT_RETAIN = 16


def _dropped(site: str):
    from ..metrics.catalog import record_dropped

    record_dropped(site)


def message_digest(message: str) -> str:
    """The ONE message-content digest both the recorder and the replay
    tool compute — byte parity of verdict messages is asserted by
    comparing these."""
    return hashlib.sha256((message or "").encode()).hexdigest()


def canonical_bytes(record: dict) -> bytes:
    """The canonical serialization the seal chain signs: sorted keys,
    compact separators, ``sig`` excluded."""
    clean = {k: v for k, v in record.items() if k != "sig"}
    return json.dumps(clean, sort_keys=True, separators=(",", ":")).encode()


def chain_sig(prev_sig: str, record: dict) -> str:
    return seal_hmac(prev_sig.encode() + canonical_bytes(record))


def verify_segment(path: str) -> Tuple[int, List[str]]:
    """Recompute one segment's HMAC chain.  Returns (records_verified,
    problems); an unsealed segment (no ``sig`` on the first line)
    verifies vacuously with a note only when sealing was expected —
    callers decide.  Any edited/reordered/malformed line breaks the
    chain from that point on."""
    problems: List[str] = []
    prev = ""
    n = 0
    try:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    problems.append(f"{path}:{lineno}: unparseable line")
                    prev = ""
                    continue
                sig = rec.get("sig")
                if sig is None:
                    problems.append(f"{path}:{lineno}: record is unsealed")
                    continue
                if chain_sig(prev, rec) != sig:
                    problems.append(
                        f"{path}:{lineno}: seal chain broken (record "
                        "edited, reordered, or chained to a tampered "
                        "predecessor)"
                    )
                prev = sig
                n += 1
    except OSError as e:
        problems.append(f"{path}: unreadable: {e}")
    return n, problems


def _mask_path(record: dict, path: str) -> bool:
    """Replace the value at a dot path with MASK_MARKER, copying the
    dicts along the path so the caller's original request object is
    never mutated.  Returns True when the path existed."""
    segs = path.split(".")
    node = record
    parents: List[Tuple[dict, str]] = []
    for seg in segs[:-1]:
        nxt = node.get(seg) if isinstance(node, dict) else None
        if not isinstance(nxt, dict):
            return False
        parents.append((node, seg))
        node = nxt
    if not isinstance(node, dict) or segs[-1] not in node:
        return False
    # copy-on-write down the path: record -> ... -> leaf parent
    rebuilt = dict(node)
    rebuilt[segs[-1]] = MASK_MARKER
    for parent, seg in reversed(parents):
        fresh = dict(parent)
        fresh[seg] = rebuilt
        rebuilt = fresh
    record.clear()
    record.update(rebuilt)
    return True


class DecisionLog:
    """One process's decision recorder: bounded queue + ring mirror on
    the record side, a writer thread owning every file operation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._ring: deque = deque(maxlen=_DEFAULT_RING)
        self._seq = 0
        self._head_n = 0          # sampled-class records seen (allow)
        self._head_kept = 0       # of those, kept by the sampler
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # configuration (configure(); read mostly)
        self._dir: Optional[str] = None
        self.sample_rate = 1.0
        self.slow_ms = 250.0
        self.mask_fields: Tuple[str, ...] = ()
        self.seal = False
        self.segment_max_bytes = _DEFAULT_SEGMENT_BYTES
        self.segment_max_s = _DEFAULT_SEGMENT_S
        self.retain = _DEFAULT_RETAIN
        self.queue_max = _DEFAULT_QUEUE
        #: master switch the replay tool flips off so replayed requests
        #: are never re-recorded into the archive they came from
        self.record_enabled = True
        # counters (exported through decision_log_* metrics and the
        # /debug/decisionz stats block)
        self.recorded = 0
        self.sampled_out = 0
        self.queue_sheds = 0
        self.segments_written = 0
        self.bytes_written = 0
        # hot-path caches + batched metric recordings: the record path
        # runs per admission, so registry records are accumulated under
        # the existing lock and flushed in batches (writer loop /
        # snapshot / stop) instead of paying a registry lock per verdict
        self._rid: Optional[str] = None
        self._brownout_ctl = None
        self._metric_classes: Dict[str, int] = {}
        self._metric_drops: Dict[str, int] = {}
        self._metric_pending = 0
        # fixed-width ms start stamp leading the segment names: restarts
        # (containers reuse PID 1; _seg_seq resets per process) must
        # never regenerate — and os.replace-clobber — a prior run's
        # segment name, and the lexicographic order _prune/segment_paths
        # rely on must stay chronological ACROSS runs
        ms = int(time.time() * 1000)  # wall-clock: ok (run name stamp)
        self._stamp = f"{ms:013d}"
        # writer-thread state (never touched on the record side)
        self._open_path: Optional[str] = None
        self._open_file = None
        self._open_bytes = 0
        self._open_records = 0
        self._open_t0 = 0.0
        self._seg_seq = 0
        self._chain_sig = ""
        self._batch_done = 0  # current drain's handled-record count

    # ---- configuration -----------------------------------------------------

    def configure(
        self,
        dir: Optional[str] = None,
        sample_rate: Optional[float] = None,
        slow_ms: Optional[float] = None,
        mask_fields: Optional[List[str]] = None,
        seal: Optional[bool] = None,
        segment_max_bytes: Optional[int] = None,
        segment_max_s: Optional[float] = None,
        retain: Optional[int] = None,
        queue_max: Optional[int] = None,
        ring_size: Optional[int] = None,
    ) -> "DecisionLog":
        with self._lock:
            if dir is not None:
                self._dir = dir or None
            if sample_rate is not None:
                self.sample_rate = min(max(float(sample_rate), 0.0), 1.0)
            if slow_ms is not None:
                self.slow_ms = float(slow_ms)
            if mask_fields is not None:
                self.mask_fields = tuple(mask_fields)
            if seal is not None:
                self.seal = bool(seal)
            if segment_max_bytes is not None:
                self.segment_max_bytes = max(int(segment_max_bytes), 4096)
            if segment_max_s is not None:
                self.segment_max_s = max(float(segment_max_s), 0.05)
            if retain is not None:
                self.retain = max(int(retain), 1)
            if queue_max is not None:
                self.queue_max = max(int(queue_max), 16)
            if ring_size is not None:
                self._ring = deque(self._ring,
                                   maxlen=max(int(ring_size), 16))
            # re-resolve cached identities: tests and fleet runtimes may
            # have changed the replica id since the last configure
            self._rid = None
        return self

    @property
    def enabled(self) -> bool:
        """Recording is live: the ring mirror always accepts; segments
        are written only when a directory is configured AND the writer
        is running."""
        return self.record_enabled

    @property
    def durable(self) -> bool:
        t = self._thread  # one read: stop() nulls it concurrently
        return self._dir is not None and t is not None and t.is_alive()

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "DecisionLog":
        """Start the writer thread (idempotent); a no-op without a
        configured directory — the ring mirror still serves decisionz."""
        if self._dir is None:
            return self
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="decisionlog-writer", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        """Flush the queue, rotate the open segment, join the writer."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            join_thread(self._thread, 5.0, "decision-log writer")
            self._thread = None
        self._flush_metrics()

    # ---- recording (hot path) ----------------------------------------------

    def _keep_sampled(self) -> bool:
        """Deterministic head sampling: keep exactly ceil-fraction of the
        sampled class, via counter rollover (no RNG on the hot path)."""
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        self._head_n += 1
        want = int(self._head_n * rate + 1e-9)
        if want > self._head_kept:
            self._head_kept = want
            return True
        return False

    #: batched registry recordings flush at this many pending counts
    METRIC_FLUSH_N = 64

    def _note_metric_locked(self, dclass: Optional[str] = None,
                            drop: Optional[str] = None):
        """Accumulate one registry recording under the already-held
        lock; callers flush outside it once the batch bound is hit."""
        if dclass is not None:
            self._metric_classes[dclass] = \
                self._metric_classes.get(dclass, 0) + 1
        if drop is not None:
            self._metric_drops[drop] = self._metric_drops.get(drop, 0) + 1
        self._metric_pending += 1

    def _flush_metrics(self):
        """Push the batched class/drop counts into the registry (the
        record fns are guarded per the telemetry contract)."""
        with self._lock:
            classes, self._metric_classes = self._metric_classes, {}
            drops, self._metric_drops = self._metric_drops, {}
            self._metric_pending = 0
        for dclass, n in classes.items():
            record_decision_record(dclass, n)
        for reason, n in drops.items():
            record_decision_dropped(reason, n)

    def _enqueue(self, record: dict, metric_class: str) -> None:
        """Queue + ring append, one lock hold.  Sheds on a full queue
        with counted drops — never blocks, never raises."""
        if self.mask_fields:
            # masking happens at record construction so the ring mirror
            # (/debug/decisionz — the MORE exposed surface) never holds
            # the redacted fields either; copy-on-write down the path,
            # the caller's request object is never mutated
            masked = [p for p in self.mask_fields if _mask_path(record, p)]
            if masked:
                record["masked"] = masked
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            self._ring.append(record)
            shed = False
            wake = False
            if self._dir is not None:
                if len(self._queue) >= self.queue_max:
                    self.queue_sheds += 1
                    shed = True
                else:
                    self._queue.append(record)
                    # no per-record wake: the writer's bounded poll
                    # (<=0.25s) drains in batches, so the hot path never
                    # pays an Event.set + thread switch per verdict; a
                    # near-full queue still wakes it early
                    wake = len(self._queue) * 2 >= self.queue_max
            self.recorded += 1
            self._note_metric_locked(dclass=metric_class,
                                     drop="queue_full" if shed else None)
            flush = self._metric_pending >= self.METRIC_FLUSH_N
        if wake:
            self._wake.set()
        if flush:
            self._flush_metrics()

    def record_admission(
        self,
        req: dict,
        resp,
        latency_s: float,
        budget_s: Optional[float] = None,
        results: Optional[list] = None,
        hint: Optional[str] = None,
    ) -> None:
        """One admission verdict.  ``resp`` is the handler's
        AdmissionResponse; ``hint`` names the failure branch the handler
        took (shed/expired/error) — without it the class derives from the
        response shape.  Guarded: a recorder defect never fails the
        admission it describes."""
        if not self.record_enabled:
            return
        try:
            # fast path, inlined: a plain fast ALLOW under no
            # degradation is the production-dominant shape, and at a 1%
            # head-sampling rate it almost always ends here — two
            # cached reads, the sampling counter under one lock hold,
            # no record construction, no extra call frames (the bench
            # gate: <3% handler-stream overhead, DECLOG_r15)
            if (hint is None and resp.allowed
                    and not getattr(resp, "annotations", None)):
                ledger = routeledger.get_active()
                route = (ledger.last_decision
                         if ledger is not None else None)
                ctl = self._brownout_ctl
                if ctl is None:
                    from . import brownout

                    ctl = self._brownout_ctl = brownout.get_controller()
                level = ctl.level
                rate = self.sample_rate
                if (rate < 1.0 and not level
                        and latency_s * 1e3 < self.slow_ms
                        and (route is None
                             or route[1] not in DEGRADED_ROUTE_REASONS)):
                    flush = False
                    with self._lock:
                        self._head_n += 1
                        want = int(self._head_n * rate + 1e-9)
                        if want > self._head_kept:
                            self._head_kept = want
                        else:
                            self.sampled_out += 1
                            drops = self._metric_drops
                            drops["sampled_out"] = \
                                drops.get("sampled_out", 0) + 1
                            self._metric_pending += 1
                            flush = (self._metric_pending
                                     >= self.METRIC_FLUSH_N)
                            if not flush:
                                return
                    if flush:
                        self._flush_metrics()
                        return
                self._emit_admission(req, resp, latency_s, budget_s,
                                     results, CLASS_ALLOW, route,
                                     int(level))
                return
            self._record_admission(req, resp, latency_s, budget_s,
                                   results, hint)
        except Exception:  # telemetry never blocks the verdict
            _dropped("decisionlog.record_admission")

    def _record_admission(self, req, resp, latency_s, budget_s,
                          results, hint):
        dclass = self.classify(resp, hint)
        route = self._current_route()
        level = self._brownout_level()
        always = (
            dclass in ALWAYS_KEEP
            or (route is not None and route[1] in DEGRADED_ROUTE_REASONS)
            or level > 0
            or latency_s * 1e3 >= self.slow_ms
        )
        if not always:
            # head-sampling decision BEFORE any record construction:
            # the sampled-out path (most allows at production rates)
            # must cost a classify + two cached reads + one lock hold
            with self._lock:
                keep = self._keep_sampled()
                if not keep:
                    self.sampled_out += 1
                    self._note_metric_locked(drop="sampled_out")
                    flush = self._metric_pending >= self.METRIC_FLUSH_N
            if not keep:
                if flush:
                    self._flush_metrics()
                return
        self._emit_admission(req, resp, latency_s, budget_s, results,
                             dclass, route, level)

    def _emit_admission(self, req, resp, latency_s, budget_s, results,
                        dclass, route, level):
        record: Dict[str, Any] = {
            "t": round(time.time(), 6),  # wall-clock: ok (record stamp)
            "kind": KIND_ADMISSION,
            "class": dclass,
            "uid": str((req or {}).get("uid", "")),
            "trace_id": obstrace.current_trace_id(),
            "replica_id": self._replica_id(),
            "verdict": {"allowed": bool(resp.allowed),
                        "code": int(resp.code)},
            "message_sha256": message_digest(resp.message),
            "latency_ms": round(latency_s * 1e3, 3),
            "deadline_budget_ms": (
                round(budget_s * 1e3, 3) if budget_s is not None else None
            ),
            "fail_open": bool(getattr(resp, "annotations", None)),
            "brownout_level": level,
            "request": req,
        }
        if route is not None:
            record["route"] = {"tier": route[0], "reason": route[1]}
        if results:
            kinds, cons = set(), set()
            for r in results:
                c = getattr(r, "constraint", None) or {}
                k = c.get("kind", "")
                kinds.add(k)
                cons.add(f"{k}/{(c.get('metadata') or {}).get('name', '')}")
            record["templates"] = sorted(kinds)[:32]
            record["constraints"] = sorted(cons)[:32]
        self._enqueue(record, dclass)

    def record_audit_transitions(
        self, new: list, resolved: list, audit_id: str
    ) -> None:
        """Violation TRANSITIONS from one completed sweep — the deltas
        the audit owner derived against its previous sweep, never the
        full violation set.  Each entry is (constraint_key, kind, ns,
        name, message_sha256).  Always-keep (they are already deltas);
        bounded per sweep with an explicit overflow summary record."""
        if not self.record_enabled:
            return
        try:
            budget = TRANSITIONS_MAX_PER_SWEEP
            emitted = 0
            for transition, entries in (("new", new), ("resolved", resolved)):
                for ck, kind, ns, name, digest in entries:
                    if emitted >= budget:
                        break
                    self._enqueue({
                        "t": round(time.time(), 6),  # wall-clock: ok (record stamp)
                        "kind": KIND_AUDIT_TRANSITION,
                        "transition": transition,
                        "replica_id": self._replica_id(),
                        "constraint": ck,
                        "resource": {"kind": kind, "namespace": ns,
                                     "name": name},
                        "message_sha256": digest,
                        "audit_id": audit_id,
                    }, KIND_AUDIT_TRANSITION)
                    emitted += 1
            overflow = (len(new) + len(resolved)) - emitted
            if overflow > 0:
                self._enqueue({
                    "t": round(time.time(), 6),  # wall-clock: ok (record stamp)
                    "kind": KIND_AUDIT_TRANSITION,
                    "transition": "overflow",
                    "replica_id": self._replica_id(),
                    "audit_id": audit_id,
                    "dropped_new": max(len(new) - emitted, 0),
                    "dropped_resolved": overflow
                    - max(len(new) - emitted, 0),
                }, KIND_AUDIT_TRANSITION)
                record_decision_dropped("transition_overflow", overflow)
        except Exception:  # telemetry never blocks the sweep
            _dropped("decisionlog.record_audit_transitions")

    @staticmethod
    def classify(resp, hint: Optional[str] = None) -> str:
        """Response shape -> decision class.  The handler's failure
        branches pass an explicit hint; fail-open responses (allowed,
        annotated) classify by their recorded reason so an allow under
        degradation is never mistaken for a policy allow."""
        if hint in CLASSES:
            return hint
        ann = getattr(resp, "annotations", None) or {}
        for v in ann.values():
            if v == "overload-shed":
                return CLASS_SHED
            if v == "deadline-exhausted":
                return CLASS_EXPIRED
            if v == "internal-error":
                return CLASS_ERROR
        if resp.allowed:
            return CLASS_ALLOW
        if resp.code == 429:
            return CLASS_SHED
        if resp.code == 504:
            return CLASS_EXPIRED
        return CLASS_DENY

    @staticmethod
    def _current_route() -> Optional[Tuple[str, str]]:
        ledger = routeledger.get_active()
        if ledger is None:
            return None
        # lock-free read of the newest (tier, reason) tuple — assigned
        # atomically by the ledger's record path
        return ledger.last_decision

    def _brownout_level(self) -> int:
        ctl = self._brownout_ctl
        if ctl is None:
            from . import brownout

            ctl = self._brownout_ctl = brownout.get_controller()
        return int(ctl.level)

    def _replica_id(self) -> str:
        rid = self._rid
        if rid is None:
            rid = self._rid = replica_id()
        return rid

    # ---- retrieval (/debug/decisionz) --------------------------------------

    def snapshot(self, limit: Optional[int] = None,
                 verdict: Optional[str] = None) -> dict:
        self._flush_metrics()  # scrape-coherent counters
        with self._lock:
            records = list(self._ring)
            stats = {
                "enabled": self.record_enabled,
                "durable": self.durable,
                "dir": self._dir,
                "sample_rate": self.sample_rate,
                "seal": self.seal,
                "recorded": self.recorded,
                "sampled_out": self.sampled_out,
                "queue_sheds": self.queue_sheds,
                "queue_depth": len(self._queue),
                "segments_written": self.segments_written,
                "bytes_written": self.bytes_written,
            }
        if verdict is not None:
            records = [r for r in records if r.get("class") == verdict]
        if limit is not None and limit >= 0:
            # limit=0 means none — a bare [-0:] would return everything
            records = records[-limit:] if limit else []
        return {"records": records, "stats": stats}

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._queue.clear()
            self._seq = 0
            self._head_n = self._head_kept = 0
            self.recorded = self.sampled_out = self.queue_sheds = 0

    # ---- writer thread -----------------------------------------------------

    def _run(self):
        while True:
            self._wake.wait(timeout=min(self.segment_max_s, 0.25))
            self._wake.clear()
            try:
                self._drain()
                self._flush_metrics()
                stopping = self._stop.is_set()
                now = time.monotonic()
                if self._open_file is not None and (
                    stopping
                    or self._open_bytes >= self.segment_max_bytes
                    or now - self._open_t0 >= self.segment_max_s
                ):
                    self._rotate()
            except Exception:
                # the writer must outlive ANY defect (the module
                # contract: failures are counted drops, never a dead
                # thread silently flipping `durable` off for good)
                _dropped("decisionlog.writer")
                log.warning("decision-log writer iteration failed",
                            exc_info=True)
                stopping = self._stop.is_set()
            if stopping:
                with self._lock:
                    empty = not self._queue
                if empty:
                    return

    def _drain(self):
        with self._lock:
            if not self._queue:
                return
            batch, self._queue = self._queue, []
        self._batch_done = 0
        try:
            self._write_records(batch)
        except OSError:
            # disk trouble: EVERY lost record is counted — the batch's
            # unwritten remainder plus whatever earlier drains appended
            # to the discarded .open segment (_open_records; already-
            # rotated segments are safe and excluded) — then keep the
            # recorder up (the ring mirror still serves decisionz)
            lost = self._open_records + (len(batch) - self._batch_done)
            record_decision_dropped("write_error", lost)
            log.warning("decision-log write failed; %d records dropped",
                        lost, exc_info=True)
            self._open_records = 0
            self._open_bytes = 0
            self._close_open(discard=True)

    def _segment_name(self) -> str:
        rid = replica_id() or "solo"
        self._seg_seq += 1
        return (
            f"decisions-{rid}-{self._stamp}-{os.getpid()}"
            f"-{self._seg_seq:05d}.ndjson"
        )

    def _ensure_open(self, directory: str):
        if self._open_file is not None:
            return
        secure_makedirs(directory)
        final = os.path.join(directory, self._segment_name())
        # hidden while open: readers list *.ndjson and must never see a
        # segment that is still being appended to
        tmp = os.path.join(directory,
                           "." + os.path.basename(final) + ".open")
        self._open_file = open(tmp, "wb")
        self._open_path = final
        self._open_bytes = 0
        self._open_records = 0
        self._open_t0 = time.monotonic()
        self._chain_sig = ""  # each segment chains independently

    def _write_records(self, records: List[dict]):
        directory = self._dir
        if directory is None:
            return
        for rec in records:
            self._ensure_open(directory)
            # ONE serialization serves both the seal and the line: the
            # canonical (sorted, compact) form is what the chain signs,
            # and the sig splices in before the closing brace — a
            # verifier that pops "sig" and re-dumps sorted reproduces
            # the exact signed bytes (verify_segment)
            try:
                canonical = json.dumps(
                    rec, sort_keys=True, separators=(",", ":")
                ).encode()
            except Exception:  # defective record: drop it, keep the rest
                _dropped("decisionlog.serialize")
                self._batch_done += 1  # accounted (not lost to disk)
                continue
            if self.seal:
                sig = seal_hmac(self._chain_sig.encode() + canonical)
                self._chain_sig = sig
                line = (canonical[:-1] + b',"sig":"' + sig.encode()
                        + b'"}\n')
            else:
                line = canonical + b"\n"
            self._open_file.write(line)
            self._open_bytes += len(line)
            self._open_records += 1
            self._batch_done += 1
            if self._open_bytes >= self.segment_max_bytes:
                # rotate mid-record-batch: one large drain must not blow
                # past the size bound into a single oversized segment
                self._open_file.flush()
                self._rotate()
        if self._open_file is not None:
            self._open_file.flush()

    def _rotate(self):
        f, final = self._open_file, self._open_path
        self._open_file = self._open_path = None
        if f is None or final is None:
            return
        tmp = f.name
        try:
            f.close()
            if self._open_bytes == 0:
                os.remove(tmp)
                return
            # atomic: readers see whole segments only
            os.replace(tmp, final)
        except OSError:
            # dir deleted / disk trouble at publish time: the segment's
            # records are lost — counted, never a dead writer (the
            # module contract)
            if self._open_bytes:
                record_decision_dropped("write_error",
                                        self._open_records)
                log.warning(
                    "decision segment publish failed; %d records "
                    "dropped", self._open_records, exc_info=True)
            self._open_bytes = self._open_records = 0
            return
        with self._lock:
            self.segments_written += 1
            self.bytes_written += self._open_bytes
        record_decision_segment(self._open_bytes)
        self._open_bytes = self._open_records = 0
        self._prune()

    def _close_open(self, discard: bool = False):
        f = self._open_file
        self._open_file = self._open_path = None
        if f is None:
            return
        try:
            f.close()
            if discard:
                os.remove(f.name)
        except OSError:
            log.debug("decision segment close failed", exc_info=True)

    def _prune(self):
        """Keep this replica's newest ``retain`` completed segments —
        other replicas' files in a shared fleet dir are never touched."""
        directory = self._dir
        if directory is None:
            return
        rid = replica_id() or "solo"
        prefix = f"decisions-{rid}-"
        try:
            names = sorted(
                n for n in os.listdir(directory)
                if n.startswith(prefix) and n.endswith(".ndjson")
            )
        except OSError:
            log.debug("decision-log retention listing failed", exc_info=True)
            return
        for name in names[:-self.retain] if len(names) > self.retain else []:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                log.debug("decision-log prune failed for %s", name,
                          exc_info=True)

    # ---- test/replay helpers ----------------------------------------------

    def flush(self, timeout_s: float = 5.0) -> None:
        """Drain the queue and rotate the open segment so every record
        so far is visible as a completed segment (tests, replay)."""
        deadline = time.monotonic() + timeout_s
        if self._thread is None or not self._thread.is_alive():
            self._drain()
            self._rotate()
            return
        while time.monotonic() < deadline:
            with self._lock:
                empty = not self._queue
            if empty and self._open_file is None:
                return
            self._wake.set()
            # ask the writer to rotate by aging the open segment out
            if self._open_t0:
                self._open_t0 = min(self._open_t0,
                                    time.monotonic() - self.segment_max_s)
            time.sleep(0.01)
        log.warning("decision-log flush timed out with work pending")


def segment_paths(log_dir: str) -> List[str]:
    """Completed decision segments under ``log_dir`` (every replica),
    oldest first by name — the replay tool's corpus listing.  Open
    (``.open``-suffixed, dot-hidden) temp files are invisible by
    construction."""
    try:
        names = sorted(
            n for n in os.listdir(log_dir)
            if n.startswith("decisions-") and n.endswith(".ndjson")
        )
    except OSError:
        return []
    return [os.path.join(log_dir, n) for n in names]


_LOG = DecisionLog()


def get_log() -> DecisionLog:
    return _LOG


def record_admission(req, resp, latency_s, budget_s=None, results=None,
                     hint=None):
    """Module-level feed so the webhook handler needs no log handle."""
    _LOG.record_admission(req, resp, latency_s, budget_s=budget_s,
                          results=results, hint=hint)


def record_audit_transitions(new, resolved, audit_id):
    _LOG.record_audit_transitions(new, resolved, audit_id)
