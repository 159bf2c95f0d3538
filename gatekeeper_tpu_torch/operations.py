"""Operations gating — which roles this process serves (reference
pkg/operations/operations.go:13-50).

A pod runs any subset of {audit, status, webhook}; default is all.  main
checks `is_assigned` before wiring the audit manager, webhook, or the
status-writing side of controllers.
"""

from __future__ import annotations

import threading
from typing import Iterable, List, Optional, Set

AUDIT = "audit"
STATUS = "status"
WEBHOOK = "webhook"

ALL_OPERATIONS = (AUDIT, STATUS, WEBHOOK)


class OperationError(ValueError):
    pass


class Operations:
    def __init__(self, assigned: Optional[Iterable[str]] = None):
        self._lock = threading.Lock()
        self._assigned: Set[str] = set()
        if assigned:
            for op in assigned:
                self.assign(op)

    def assign(self, op: str):
        """The repeatable --operation flag (operations.go:33-58)."""
        if op not in ALL_OPERATIONS:
            raise OperationError(f"unrecognized operation: {op}")
        with self._lock:
            self._assigned.add(op)

    def is_assigned(self, op: str) -> bool:
        """operations.go:96-104: empty assignment means ALL operations."""
        with self._lock:
            if not self._assigned:
                return True
            return op in self._assigned

    def assigned_string_list(self) -> List[str]:
        """Sorted list of assigned ops (operations.go:106-118)."""
        with self._lock:
            ops = self._assigned or set(ALL_OPERATIONS)
        return sorted(ops)

    # ---- single-role helpers (fleet serving, docs/fleet.md) ----------------

    def assigned_set(self) -> Set[str]:
        """The effective operation set (empty assignment = ALL)."""
        with self._lock:
            return set(self._assigned or ALL_OPERATIONS)

    def is_only(self, op: str) -> bool:
        """True when this process serves exactly one role, `op` — the
        fleet's webhook replicas assert this to prove no audit manager,
        snapshot writer, or status writer rides along."""
        return self.assigned_set() == {op}

    def explicitly_assigned(self) -> bool:
        """True when --operation was passed at least once (the process is
        a deliberately single/limited-role fleet member, not a default
        run-everything singleton)."""
        with self._lock:
            return bool(self._assigned)


# process-global default, mirroring the reference's package-level singleton
_default = Operations()


def get() -> Operations:
    return _default


def reset_for_test(assigned: Optional[Iterable[str]] = None) -> Operations:
    global _default
    _default = Operations(assigned)
    return _default
