"""Process excluder — per-process excluded-namespace sets (reference
pkg/controller/config/process/excluder.go:10-86).

Built from the Config CRD's spec.match[] entries; '*' expands to every
process.  The webhook, audit manager and sync controller each consult their
own process name before touching an object.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Set

from ..apis.config import MatchEntry

AUDIT = "audit"
SYNC = "sync"
WEBHOOK = "webhook"
STAR = "*"

ALL_PROCESSES = (AUDIT, WEBHOOK, SYNC)


class Excluder:
    def __init__(self):
        self._lock = threading.RLock()
        self._excluded: Dict[str, Set[str]] = {}

    def add(self, entries: Iterable[MatchEntry]):
        """excluder.go:44-68."""
        with self._lock:
            for entry in entries:
                for ns in entry.excluded_namespaces:
                    for op in entry.processes:
                        procs = ALL_PROCESSES if op == STAR else (op,)
                        for p in procs:
                            self._excluded.setdefault(p, set()).add(ns)

    def replace(self, new: "Excluder"):
        """excluder.go:70-74: atomic swap on config change."""
        with self._lock, new._lock:
            self._excluded = {p: set(s) for p, s in new._excluded.items()}

    def equals(self, other: "Excluder") -> bool:
        with self._lock, other._lock:
            return self._excluded == other._excluded

    def is_namespace_excluded(self, process: str, namespace: str) -> bool:
        with self._lock:
            return namespace in self._excluded.get(process, ())
