"""Readiness tracker (reference pkg/readiness/): the startup gate.

Before a pod reports ready it must have ingested every pre-existing
ConstraintTemplate, every constraint of every template's kind, the Config
singleton, and every to-be-synced data object — otherwise the webhook could
serve decisions from a partially-rebuilt engine.  Controllers call
`tracker.for_gvk(...).observe(obj)` as they ingest; `run()` seeds the
expectations by listing current state (ready_tracker.go:176-225).

Satisfaction circuit-breaks: once a tracker is satisfied it stays satisfied
and drops its bookkeeping (ready_tracker.go:137-172, object_tracker.go).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Set, Tuple

from ..apis.config import CONFIG_NAME
from ..apis.config import GVK as CONFIG_GVK
from ..apis.config import parse_config
from ..kube.inmem import InMemoryKube, obj_key as _key
from ..util import nested_get

GVK = Tuple[str, str, str]

TEMPLATES_GVK = ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
CONSTRAINTS_GROUP = "constraints.gatekeeper.sh"

# TryCancelExpect cancels only after this many attempts for the same object
# (object_tracker.go tryCancelled semantics)
TRY_CANCEL_THRESHOLD = 3


def template_constraint_kind(template: dict) -> Optional[str]:
    return nested_get(template, "spec", "crd", "spec", "names", "kind")


class ObjectTracker:
    """Expectations for one GVK (object_tracker.go:33-62)."""

    def __init__(self, gvk: GVK):
        self.gvk = gvk
        self._lock = threading.RLock()
        self._expect: Set[Tuple[str, str]] = set()
        self._seen: Set[Tuple[str, str]] = set()
        self._canceled: Set[Tuple[str, str]] = set()
        self._try_cancels: Dict[Tuple[str, str], int] = {}
        self._populated = False
        self._satisfied = False  # circuit breaker

    def expect(self, obj: dict):
        with self._lock:
            if self._satisfied:
                return
            self._expect.add(_key(obj))

    def observe(self, obj: dict):
        with self._lock:
            if self._satisfied:
                return
            self._seen.add(_key(obj))

    def cancel_expect(self, obj: dict):
        """Deleted-but-expected objects stop blocking readiness
        (object_tracker.go CancelExpect)."""
        with self._lock:
            if self._satisfied:
                return
            self._canceled.add(_key(obj))

    def try_cancel_expect(self, obj: dict) -> bool:
        """Soft cancel: only takes effect after TRY_CANCEL_THRESHOLD calls
        for the same object — guards against transient NotFound races."""
        with self._lock:
            if self._satisfied:
                return True
            k = _key(obj)
            n = self._try_cancels.get(k, 0) + 1
            self._try_cancels[k] = n
            if n >= TRY_CANCEL_THRESHOLD:
                self._canceled.add(k)
                return True
            return False

    def expectations_done(self):
        """No further Expect calls will arrive (population finished)."""
        with self._lock:
            self._populated = True

    @property
    def populated(self) -> bool:
        with self._lock:
            return self._populated

    def satisfied(self) -> bool:
        with self._lock:
            if self._satisfied:
                return True
            if not self._populated:
                return False
            if self._expect <= (self._seen | self._canceled):
                # circuit break: free the bookkeeping
                self._satisfied = True
                self._expect.clear()
                self._seen.clear()
                self._canceled.clear()
                self._try_cancels.clear()
                return True
            return False

    def cancel_all(self):
        """Stop tracking this kind entirely (its source object is gone):
        short-circuit to satisfied."""
        with self._lock:
            self._populated = True
            self._satisfied = True
            self._expect.clear()
            self._seen.clear()
            self._canceled.clear()
            self._try_cancels.clear()

    def pending(self) -> Set[Tuple[str, str]]:
        with self._lock:
            if self._satisfied:
                return set()
            return self._expect - self._seen - self._canceled


class Tracker:
    """ready_tracker.go: the aggregate gate over templates, per-kind
    constraints, config, and synced data."""

    def __init__(self):
        self._lock = threading.RLock()
        self.templates = ObjectTracker(TEMPLATES_GVK)
        self.config = ObjectTracker(CONFIG_GVK)
        self._constraints: Dict[GVK, ObjectTracker] = {}
        self._data: Dict[GVK, ObjectTracker] = {}
        self._constraints_populated = False
        self._data_populated = False
        self._satisfied = False
        self._seeded = False  # run() finished; late trackers are born populated

    # ---- tracker access (ready_tracker.go For/ForData) -------------------

    def for_gvk(self, gvk: GVK) -> ObjectTracker:
        if gvk == TEMPLATES_GVK:
            return self.templates
        if gvk == CONFIG_GVK:
            return self.config
        with self._lock:
            tr = self._constraints.get(gvk)
            if tr is None:
                tr = self._constraints[gvk] = ObjectTracker(gvk)
                if self._seeded:
                    # kinds appearing after seeding carry no startup debt
                    tr.expectations_done()
            return tr

    def for_data(self, gvk: GVK) -> ObjectTracker:
        with self._lock:
            tr = self._data.get(gvk)
            if tr is None:
                tr = self._data[gvk] = ObjectTracker(gvk)
                if self._seeded:
                    tr.expectations_done()
            return tr

    def cancel_template(self, template: dict):
        """Template deleted (or failed compile) during startup: cancel it AND
        its constraint kind's expectations — those constraints can never be
        observed once the kind's watch is gone (collectForObjectTracker,
        ready_tracker.go:228-260)."""
        self.templates.cancel_expect(template)
        kind = template_constraint_kind(template)
        if kind:
            with self._lock:
                tr = self._constraints.get((CONSTRAINTS_GROUP, "v1beta1", kind))
            if tr is not None:
                tr.cancel_all()

    # ---- seeding ----------------------------------------------------------

    def run(self, kube: InMemoryKube):
        """Seed expectations from current cluster state
        (ready_tracker.go:176-225).  Templates and config are listed here;
        constraints per kind are expected from each template's listed CRs;
        data expectations come from the Config sync set."""
        templates = kube.list(TEMPLATES_GVK)
        for t in templates:
            self.templates.expect(t)
        self.templates.expectations_done()

        # constraints: for each template kind, expect existing CRs
        for t in templates:
            kind = template_constraint_kind(t)
            if not kind:
                continue
            cgvk = (CONSTRAINTS_GROUP, "v1beta1", kind)
            tr = self.for_gvk(cgvk)
            for c in kube.list(cgvk):
                tr.expect(c)
            tr.expectations_done()
        with self._lock:
            self._constraints_populated = True

        # config + data sync set
        cfg = None
        try:
            cfg = kube.get(CONFIG_GVK, CONFIG_NAME, "gatekeeper-system")
        except Exception:
            # only the singleton name is honored — a config with any other
            # name is ignored by the config controller, so expecting it
            # would deadlock readiness (ready_tracker.go skips them)
            for c in kube.list(CONFIG_GVK):
                if _key(c)[1] == CONFIG_NAME:
                    cfg = c
                    break
        if cfg is not None:
            self.config.expect(cfg)
            spec = parse_config(cfg)
            for entry in spec.sync_only:
                gvk = entry.gvk()
                tr = self.for_data(gvk)
                for obj in kube.list(gvk):
                    tr.expect(obj)
                tr.expectations_done()
        self.config.expectations_done()
        with self._lock:
            self._data_populated = True
            self._seeded = True

    def collect(self, kube: InMemoryKube):
        """Cancel expectations for objects that no longer exist — the
        periodic deleted-object collection of ready_tracker.go:198-218 /
        collectForObjectTracker:228-260.  Covers objects deleted in the
        window between run() seeding and watch registration, when no
        DELETED tombstone is ever delivered."""

        def _collect(tr: ObjectTracker, gvk: GVK):
            pending = tr.pending()
            if not pending:
                return
            live = {_key(o) for o in kube.list(gvk)}
            for ns, name in pending - live:
                tr.cancel_expect({"metadata": {"namespace": ns, "name": name}})

        _collect(self.templates, TEMPLATES_GVK)
        _collect(self.config, CONFIG_GVK)
        with self._lock:
            items = list(self._constraints.items()) + list(self._data.items())
        for gvk, tr in items:
            _collect(tr, gvk)
        # a template canceled above can never deliver its constraints
        live_templates = kube.list(TEMPLATES_GVK)
        live_kinds = {template_constraint_kind(t) for t in live_templates}
        with self._lock:
            constraint_items = list(self._constraints.items())
        for gvk, tr in constraint_items:
            if gvk[2] not in live_kinds:
                tr.cancel_all()

    # ---- satisfaction -----------------------------------------------------

    def satisfied(self) -> bool:
        with self._lock:
            if self._satisfied:
                return True
        # templates gate constraints (ready_tracker.go:137-172: template
        # expectations must resolve before constraint kinds are authoritative)
        if not self.templates.satisfied():
            return False
        with self._lock:
            if not (self._constraints_populated and self._data_populated):
                return False
            trackers = list(self._constraints.values()) + list(self._data.values())
        if not all(t.satisfied() for t in trackers):
            return False
        if not self.config.satisfied():
            return False
        with self._lock:
            self._satisfied = True
        return True

    def wait_satisfied(self, timeout: float = 10.0, poll: float = 0.02) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.satisfied():
                return True
            time.sleep(poll)
        return self.satisfied()

    def pending_summary(self) -> Dict[str, list]:
        out = {}
        if not self.templates.satisfied():
            out["templates"] = sorted(self.templates.pending())
        with self._lock:
            items = list(self._constraints.items()) + list(self._data.items())
        for gvk, tr in items:
            if not tr.satisfied():
                out[str(gvk)] = sorted(tr.pending())
        return out
