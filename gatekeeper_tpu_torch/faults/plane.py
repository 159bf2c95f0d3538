"""The deterministic fault plane: named injection points with seeded
per-point schedules.

A `FaultPlane` owns a set of named injection points.  Production code
threads a point through a hot path as:

    from .. import faults
    ...
    if faults.ENABLED:                 # one module-attr read + branch
        faults.fire("tpu.dispatch")

The plane is process-global and OFF by default (`faults.ENABLED` is
False until `faults.install()` runs), so the only cost a production
request pays is that single flag check.  Tests install a plane with an
explicit seed and per-point `FaultRule` schedules; every probabilistic
decision comes from a per-point `random.Random` seeded from
(plane seed, point name), so a given (seed, schedule, call sequence)
always produces the same fault sequence.

Fault modes:
  error    raise `rule.error` (an Exception instance, an Exception class,
           or a zero-arg callable returning one); default `FaultError`
  latency  sleep `rule.latency_s` then return normally
  hang     block for up to `rule.hang_s` or until the plane's release
           event is set (`plane.release_hangs()`), then return normally —
           a BOUNDED stand-in for a wedged backend, so no test can wait
           forever on an injected hang
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

from ..obs import trace as obstrace

ERROR = "error"
LATENCY = "latency"
HANG = "hang"

_MODES = (ERROR, LATENCY, HANG)


class FaultError(Exception):
    """Default injected failure."""


@dataclass
class FaultRule:
    """One scheduled fault at one injection point.

    probability  chance each arrival (past `after`) fires this rule
    count        max fires before the rule goes dormant (None = unlimited)
    after        arrivals to let through before the rule becomes eligible
    """

    mode: str = ERROR
    probability: float = 1.0
    count: Optional[int] = None
    after: int = 0
    latency_s: float = 0.0
    hang_s: float = 1.0
    error: Union[None, Exception, Callable[[], Exception], type] = None
    # bookkeeping (mutated by the plane under its lock)
    fires: int = field(default=0, compare=False)
    seen: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}")

    def make_error(self, point: str) -> Exception:
        e = self.error
        if e is None:
            return FaultError(f"injected fault at {point}")
        if isinstance(e, Exception):
            return e
        return e()  # class or factory


class FaultPlane:
    """Seeded, thread-safe registry of injection-point schedules."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rules: Dict[str, List[FaultRule]] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._lock = threading.Lock()
        self._release = threading.Event()
        # observability: arrivals and fires per point, mode of each fire
        self.stats: Dict[str, Dict[str, int]] = {}

    # ---- schedule management ----------------------------------------------

    def add(self, point: str, rule: FaultRule) -> FaultRule:
        with self._lock:
            self._rules.setdefault(point, []).append(rule)
            if point not in self._rngs:
                # deterministic per-point stream independent of add order
                self._rngs[point] = random.Random((self.seed, point).__repr__())
        return rule

    def clear(self, point: Optional[str] = None):
        """Drop the schedule for one point (or every point)."""
        with self._lock:
            if point is None:
                self._rules.clear()
            else:
                self._rules.pop(point, None)

    def release_hangs(self):
        """Unblock every in-flight (and future) hang fault."""
        self._release.set()

    def points(self) -> List[str]:
        with self._lock:
            return sorted(self._rules)

    # ---- the hot-path entry ------------------------------------------------

    def fire(self, point: str, **ctx):
        """Evaluate the point's schedule; acts on at most ONE rule per
        arrival (first eligible in add order).  The decision is made under
        the lock; the act (sleep/hang/raise) happens outside it."""
        act: Optional[FaultRule] = None
        with self._lock:
            rules = self._rules.get(point)
            if not rules:
                return
            st = self.stats.setdefault(
                point, {"arrivals": 0, "fires": 0}
            )
            st["arrivals"] += 1
            rng = self._rngs[point]
            for rule in rules:
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue
                if rule.count is not None and rule.fires >= rule.count:
                    continue
                if rule.probability < 1.0 and rng.random() >= rule.probability:
                    continue
                rule.fires += 1
                st["fires"] += 1
                st[rule.mode] = st.get(rule.mode, 0) + 1
                act = rule
                break
        if act is None:
            return
        # trace visibility: a chaos-test failure should show WHERE the
        # injected fault landed inside the trace, not just that latency
        # (or an error) appeared somewhere
        obstrace.add_event(
            "fault_injected", point=point, mode=act.mode,
            delay_s=(
                act.latency_s if act.mode == LATENCY
                else act.hang_s if act.mode == HANG else 0.0
            ),
        )
        if act.mode == LATENCY:
            time.sleep(act.latency_s)
            return
        if act.mode == HANG:
            self._release.wait(act.hang_s)
            return
        raise act.make_error(point)
