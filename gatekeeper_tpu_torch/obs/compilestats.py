"""Compile/device telemetry: every XLA
compile the engine pays, attributed — which executable (path), cold vs
cache-warm, AOT-deserialize vs persistent-cache vs fresh compile — plus
the async-compile epoch lag and device-memory accounting for the packed
[C, R] arrays and mesh slabs.  `/debug/compilez` (obs/debug.py) serves
the summary; cold-start attribution stops being guesswork.

Sources:

- ``ops/aotcache.py aot_jit`` records every executable build: an AOT
  cache deserialize (provenance ``aot``), or a lower+compile classified
  by whether jax's persistent compilation cache answered during it
  (``persistent`` vs ``cold`` — via the xlacache monitoring counters
  mirrored here; ``unknown`` when the jax build lacks the counters).
  XLA ``cost_analysis()`` flops/bytes ride along when available.
- ``ops/asynccompile.py`` records per-epoch background compiles (path
  ``epoch``, wall time of the whole warm dispatch) and the
  ``compile_epoch_lag`` gauge — mutation epoch minus compiled epoch,
  the backlog the audit wait loop previously inferred blind.
- ``ops/driver.py`` records device-memory bytes at every placement
  chokepoint: the device-resident audit pack, the sharded mesh slabs,
  and the replicated constraint side (gauge ``device_bytes{component}``).
- ``ops/xlacache.py`` reports whether the persistent-cache hit/miss
  counters exist at all (``xlacache_counters_available`` — the
  counted-drops contract applied to silently-absent instrumentation).

Everything here is guarded: telemetry never blocks a compile.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

#: provenance values a compile event may carry (docs/observability.md):
#: ``aot`` = deserialized from the AOT executable cache, ``persistent``
#: = lower+compile answered by jax's persistent compilation cache,
#: ``cold`` = a genuinely fresh XLA compile, ``unknown`` = no counters
#: to classify with, ``async`` = a whole background epoch warm
#: (ops/asynccompile.py; its inner executables classify separately)
PROVENANCES = ("aot", "persistent", "cold", "unknown", "async")

_RING = 128


class CompileStats:
    def __init__(self, maxlen: int = _RING):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(maxlen), 16))
        self.enabled = True
        # (path, provenance) -> count; seconds totals per path
        self._mix: Dict[tuple, int] = {}
        self._seconds: Dict[str, float] = {}
        self._epoch_lag = 0
        self._epoch_lag_max = 0
        # component -> {"bytes": n, ...extras}
        self._device_bytes: Dict[str, dict] = {}
        # persistent-cache counters mirrored from the xlacache listener
        self.xla_hits = 0
        self.xla_misses = 0
        self.xla_counters_available: Optional[bool] = None

    # ---- compile events ----------------------------------------------------

    def record_compile(self, path: str, seconds: float, provenance: str,
                       epoch: Optional[int] = None,
                       flops: Optional[float] = None,
                       bytes_accessed: Optional[float] = None):
        """One executable build/load.  Guarded by callers' contract: this
        method itself only takes the stats lock."""
        if not self.enabled:
            return
        ev = {
            # the duration itself was measured with perf_counter upstream
            "t": round(time.time(), 6),  # wall-clock: ok (event stamp)
            "path": path,
            "seconds": round(float(seconds), 6),
            "provenance": provenance,
        }
        if epoch is not None:
            ev["epoch"] = int(epoch)
        if flops is not None:
            ev["flops"] = float(flops)
        if bytes_accessed is not None:
            ev["bytes_accessed"] = float(bytes_accessed)
        with self._lock:
            self._ring.append(ev)
            key = (path, provenance)
            self._mix[key] = self._mix.get(key, 0) + 1
            self._seconds[path] = self._seconds.get(path, 0.0) + float(
                seconds
            )

    # ---- epoch lag ---------------------------------------------------------

    def record_epoch_lag(self, lag: int):
        lag = max(int(lag), 0)
        with self._lock:
            self._epoch_lag = lag
            self._epoch_lag_max = max(self._epoch_lag_max, lag)
        from ..metrics.catalog import record_compile_lag

        record_compile_lag(lag)

    def epoch_lag(self) -> int:
        with self._lock:
            return self._epoch_lag

    # ---- device memory -----------------------------------------------------

    def record_device_bytes(self, component: str, nbytes: int, **extra):
        with self._lock:
            self._device_bytes[component] = {
                "bytes": int(nbytes),
                "t": round(time.time(), 6),  # wall-clock: ok (placement)
                **extra,
            }
        from ..metrics.catalog import record_device_bytes

        record_device_bytes(component, nbytes)

    # ---- xlacache counters -------------------------------------------------

    def note_xla_event(self, hit: bool):
        with self._lock:
            if hit:
                self.xla_hits += 1
            else:
                self.xla_misses += 1

    def xla_counters(self) -> tuple:
        with self._lock:
            return self.xla_hits, self.xla_misses

    def set_xla_counters_available(self, ok: bool):
        with self._lock:
            self.xla_counters_available = bool(ok)
        from ..metrics.catalog import record_xla_counters_available

        record_xla_counters_available(ok)

    # ---- retrieval ---------------------------------------------------------

    def provenance_mix(self) -> Dict[str, int]:
        """{"path|provenance": count} over every recorded compile."""
        with self._lock:
            return {
                f"{path}|{prov}": n
                for (path, prov), n in sorted(self._mix.items())
            }

    def snapshot(self, limit: Optional[int] = None) -> dict:
        """The `/debug/compilez` payload."""
        with self._lock:
            recent = list(self._ring)
            mix = {
                f"{path}|{prov}": n
                for (path, prov), n in sorted(self._mix.items())
            }
            seconds = {
                path: round(s, 6)
                for path, s in sorted(self._seconds.items())
            }
            out = {
                "compile_epoch_lag": self._epoch_lag,
                "compile_epoch_lag_max": self._epoch_lag_max,
                "device_bytes": {
                    k: dict(v)
                    for k, v in sorted(self._device_bytes.items())
                },
                "xlacache": {
                    "counters_available": self.xla_counters_available,
                    "hits": self.xla_hits,
                    "misses": self.xla_misses,
                },
                "provenance_mix": mix,
                "compile_seconds_total": seconds,
                "enabled": self.enabled,
            }
        if limit is not None and limit >= 0:
            # limit=0 means none — a bare [-0:] would return everything
            recent = recent[-limit:] if limit else []
        out["recent"] = recent
        return out

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._mix.clear()
            self._seconds.clear()
            self._epoch_lag = 0
            self._epoch_lag_max = 0
            self._device_bytes.clear()
            self.xla_hits = 0
            self.xla_misses = 0


_STATS = CompileStats()


def get_stats() -> CompileStats:
    return _STATS


def record_compile(path: str, seconds: float, provenance: str,
                   epoch: Optional[int] = None,
                   flops: Optional[float] = None,
                   bytes_accessed: Optional[float] = None):
    """Module-level feed, guarded — the compile paths call this without
    a handle and must never fail on telemetry."""
    try:
        _STATS.record_compile(path, seconds, provenance, epoch=epoch,
                              flops=flops, bytes_accessed=bytes_accessed)
    except Exception:  # telemetry never blocks a compile
        from ..metrics.catalog import record_dropped

        record_dropped("compilestats.record_compile")


def record_epoch_lag(lag: int):
    try:
        _STATS.record_epoch_lag(lag)
    except Exception:  # telemetry never blocks a mutation
        from ..metrics.catalog import record_dropped

        record_dropped("compilestats.record_epoch_lag")


def record_device_bytes(component: str, nbytes: int, **extra):
    try:
        _STATS.record_device_bytes(component, nbytes, **extra)
    except Exception:  # telemetry never blocks a placement
        from ..metrics.catalog import record_dropped

        record_dropped("compilestats.record_device_bytes")


def tree_nbytes(tree) -> int:
    """Total array bytes across a tree's leaves (host numpy arrays or
    torch tensors, nested in dicts, lists and tuples — both expose
    nbytes); non-array leaves count zero."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0) or 0)
