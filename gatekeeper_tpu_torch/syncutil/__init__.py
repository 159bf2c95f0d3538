"""Synchronization utilities (reference pkg/syncutil/).

- SingleRunner: keyed singleton workers with per-key cancel
  (single_runner.go:28-44); keys are single-use, duplicate scheduling is
  silently ignored
- SyncBool: lock-guarded boolean (syncbool.go)
- backoff: capped exponential backoff with jitter (backoff.go /
  wait.ExponentialBackoff usage across audit/upgrade loops)
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional


class SyncBool:
    def __init__(self, value: bool = False):
        self._lock = threading.Lock()
        self._value = value

    def get(self) -> bool:
        with self._lock:
            return self._value

    def set(self, value: bool):
        with self._lock:
            self._value = value


class Backoff:
    """Capped exponential backoff with deterministic-seedable jitter.

    The nominal schedule is base * factor^k hard-capped at `cap`; each
    interval is then jittered DOWNWARD into [nominal * (1 - jitter),
    nominal], so the cap stays a hard upper bound while a fleet of
    reconnecting watchers desynchronizes instead of storming the API
    server in lockstep.  Pass a seeded `random.Random` for reproducible
    schedules (the chaos suite does)."""

    def __init__(
        self,
        base: float = 0.05,
        factor: float = 2.0,
        cap: float = 2.0,
        jitter: float = 0.5,
        rng: Optional[random.Random] = None,
    ):
        if base <= 0 or factor < 1.0 or cap < base:
            raise ValueError("backoff requires base > 0, factor >= 1, "
                             "cap >= base")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.base = base
        self.factor = factor
        self.cap = cap
        self.jitter = jitter
        self._rng = rng or random.Random()
        self._cur = base

    def next(self) -> float:
        """The next sleep interval; advances the schedule."""
        nominal = min(self._cur, self.cap)
        self._cur = min(self._cur * self.factor, self.cap)
        if self.jitter:
            nominal -= nominal * self.jitter * self._rng.random()
        return nominal

    def reset(self):
        """Back to the base interval (call after a successful attempt)."""
        self._cur = self.base


def backoff_intervals(
    initial: float = 1.0,
    factor: float = 2.0,
    steps: int = 5,
    jitter: float = 0.0,
) -> Iterator[float]:
    """The wait.Backoff{Duration,Factor,Jitter,Steps} shape the reference
    uses for its retry loops (audit manager.go:693-700)."""
    d = initial
    for _ in range(steps):
        if jitter > 0:
            yield d + random.uniform(0, d * jitter)
        else:
            yield d
        d *= factor


def retry_with_backoff(
    fn: Callable[[], bool],
    initial: float = 0.05,
    factor: float = 2.0,
    steps: int = 5,
) -> bool:
    """Run fn until it returns True (done) or steps are exhausted."""
    if fn():
        return True
    for interval in backoff_intervals(initial, factor, steps - 1):
        time.sleep(interval)
        if fn():
            return True
    return False


class SingleRunner:
    """Keyed singleton worker threads.  Each key schedules at most once for
    the runner's lifetime; cancel(key) signals that worker's stop event.
    Workers receive the stop event and must respect it, as goroutines
    respect their context in the reference."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cancels: Dict[str, threading.Event] = {}
        self._threads: List[threading.Thread] = []
        self._done = False

    def schedule(self, key: str, fn: Callable[[threading.Event], None]) -> bool:
        """Start fn(stop_event) under key; returns False if the key was
        already used (silently ignored, single_runner.go:28-44) or the
        runner is shut down."""
        with self._lock:
            if self._done or key in self._cancels:
                return False
            stop = threading.Event()
            self._cancels[key] = stop
            t = threading.Thread(
                target=fn, args=(stop,), name=f"single-{key}", daemon=True
            )
            self._threads.append(t)
            t.start()
            return True

    def cancel(self, key: str):
        with self._lock:
            ev = self._cancels.get(key)
        if ev is not None:
            ev.set()

    def wait(self, timeout: Optional[float] = None):
        """Cancel everything and join all workers."""
        with self._lock:
            self._done = True
            events = list(self._cancels.values())
            threads = list(self._threads)
        for ev in events:
            ev.set()
        deadline = (time.monotonic() + timeout) if timeout else None
        for t in threads:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            t.join(timeout=remaining)
