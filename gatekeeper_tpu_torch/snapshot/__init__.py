"""State snapshot & warm-resume subsystem.

Persists the serving state whose rebuild dominates a cold start — the
interner vocabulary, the packed audit column store, and the template/
constraint registry — to a versioned, HMAC-sealed on-disk snapshot, and
restores it on startup with a resourceVersion-driven delta resync so a
restarted process's first audit sweep costs O(churn while down) instead
of O(cluster).  See docs/snapshots.md.

    SnapshotWriter  — capture + atomic persist + retention
    Snapshotter     — background cadence thread (audit-sweep hooked)
    SnapshotLoader  — validate + restore + delta resync, cold-path
                      fallback on ANY validation failure
    SnapshotError   — the "not usable, fall back" signal
"""

from .format import SnapshotError
from .loader import SnapshotLoader
from .writer import Snapshotter, SnapshotWriter

__all__ = [
    "SnapshotError",
    "SnapshotLoader",
    "Snapshotter",
    "SnapshotWriter",
]
