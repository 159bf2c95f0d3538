"""Per-request deadline budgets and overload refusal.

The webhook server stamps each admission request with an absolute
monotonic deadline derived from its budget; everything downstream on the
same thread (micro-batcher enqueue, driver fallback ladders) reads it
through this module and refuses to start work it can no longer finish.
An exhausted budget surfaces as `DeadlineExceeded`, which the validation
handler converts into an explicit fail-open or fail-closed admission
decision — never a socket timeout.

End-to-end propagation (docs/failure-modes.md): the budget is
``min()`` over every bound the request carries — the configured
``--admission-deadline-budget-ms``, the AdmissionReview's own
``request.timeoutSeconds`` (the webhook configuration's timeout, when
the caller stamps it onto the request — an opportunistic source, never
required), and the **remaining** wire budget a fleet front door
forwards in the ``X-GK-Deadline-Ms`` header (:data:`DEADLINE_HEADER`).  A replica behind
the door therefore re-enters ``push`` with what is actually left of the
caller's patience, not a fresh budget; :func:`effective_budget_s` is the
shared min() so the door and the webhook cannot drift.

`OverloadShed` is the sibling refusal: not "too late" but "too full" —
raised by bounded queues (micro-batcher ``max_pending``, the front
door's per-backend inflight bound) when accepting the request would
push service time past every deadline anyway.  Both are converted to
the same explicit fail-open/closed decision.

The deadline rides a ContextVar: each webhook handler thread carries its
own, and code with no deadline set (audit sweeps, tests, background
threads) sees None everywhere and pays nothing.
"""

from __future__ import annotations

import contextvars
import math
import time
from contextlib import contextmanager
from typing import Optional

#: the wire header carrying the REMAINING budget, in milliseconds, across
#: the front-door hop (and any future proxy hop: the contract is
#: transport-agnostic — the event-edge wire protocol carries the same
#: remaining-budget value in its request frames, fleet/wireproto.py)
DEADLINE_HEADER = "X-GK-Deadline-Ms"


class DeadlineExceeded(Exception):
    """The request's deadline budget is exhausted."""


class OverloadShed(RuntimeError):
    """The request was refused by a bounded queue under overload — an
    explicit, immediate backpressure decision (docs/failure-modes.md
    shed order), never a slow timeout."""


_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "gk_deadline", default=None
)


def push(budget_s: float):
    """Set the current context's deadline to now + budget_s; returns a
    token for `pop`."""
    return _ctx.set(time.monotonic() + budget_s)


def pop(token):
    _ctx.reset(token)


def current() -> Optional[float]:
    """The absolute monotonic deadline, or None when no budget is set."""
    return _ctx.get()


def remaining() -> Optional[float]:
    """Seconds left (may be negative), or None when no budget is set."""
    dl = _ctx.get()
    return None if dl is None else dl - time.monotonic()


def remaining_ms() -> Optional[float]:
    """Milliseconds left (may be negative), or None when no budget is
    set — the value a proxy hop forwards in DEADLINE_HEADER."""
    r = remaining()
    return None if r is None else r * 1e3


def effective_budget_s(*candidates: Optional[float]) -> Optional[float]:
    """min() over the present budget bounds, in seconds.  None entries
    are 'no bound from this source'; all-None means no deadline at all.
    A zero or negative candidate is preserved (not clamped): it means
    the budget is ALREADY exhausted, and the caller must refuse the work
    explicitly rather than run it with a fabricated allowance."""
    present = [c for c in candidates if c is not None]
    return min(present) if present else None


def parse_header_ms(value) -> Optional[float]:
    """DEADLINE_HEADER value -> seconds, defensively: a malformed header
    from an unknown proxy must not 500 the request — it simply carries
    no bound."""
    if value is None:
        return None
    try:
        s = float(value) / 1e3
    except (TypeError, ValueError):
        return None
    # NaN/inf would poison every downstream comparison and socket
    # timeout (NaN compares False against everything, so an expired
    # check never fires and settimeout(nan) raises mid-proxy)
    return s if math.isfinite(s) else None


def parse_timeout_seconds(req: dict) -> Optional[float]:
    """``request.timeoutSeconds`` from an AdmissionReview request dict
    — the webhook configuration's timeout, when the apiserver (or the
    harness driving this webhook) stamps it onto the request.  Absent
    or non-numeric -> None: this source is opportunistic, and the
    configured ``--admission-deadline-budget-ms`` / forwarded wire
    budget still apply without it.  Bools are excluded (True is an int
    in Python, and `timeoutSeconds: true` is corruption, not a
    1-second budget)."""
    if not isinstance(req, dict):
        return None
    v = req.get("timeoutSeconds")
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    v = float(v)
    # json.loads happily produces NaN/Infinity; neither is a budget
    return v if math.isfinite(v) else None


def expired() -> bool:
    dl = _ctx.get()
    return dl is not None and time.monotonic() > dl


@contextmanager
def budget(budget_s: float):
    """Scope a deadline budget around a block (tests, embedders)."""
    token = push(budget_s)
    try:
        yield
    finally:
        pop(token)
