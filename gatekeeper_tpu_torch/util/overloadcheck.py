"""Shared overload-response taxonomy for the proof harnesses.

`bench.py overload` and `tools/check_overload.py` both classify every
wire response into the docs/failure-modes.md taxonomy and compare
accepted verdicts against the interpreter oracle; the classification
rules (which HTTP/status-code combinations are a shed vs an expiry vs
an accepted admission, and how webhook deny messages normalize against
oracle messages) are load-bearing for BOTH the tier-1 conformance gate
and the recorded artifact — one copy, so they cannot drift apart.
"""

from __future__ import annotations

import json
import re
from typing import Optional, Tuple

ACCEPTED = "accepted"
SHED = "shed"
EXPIRED = "expired"
PROBLEM = "problem"

_DENY_PREFIX = re.compile(r"^\[denied by [^\]]+\] ")


def classify_response(status: int, data: bytes
                      ) -> Tuple[str, Optional[dict]]:
    """-> (ACCEPTED|SHED|EXPIRED|PROBLEM, parsed response|None).

    The taxonomy of docs/failure-modes.md: a 429 at the door or a
    200-wrapped code-429 verdict is a shed; a 200-wrapped code-504 is a
    deadline expiry; any other 200 is an accepted admission; everything
    else (502s, unparseable bodies, refusals WITHOUT an explicit
    allowed verdict) is unexplained."""
    if status not in (200, 429):
        return PROBLEM, None
    try:
        out = json.loads(data)["response"]
    except Exception:
        return PROBLEM, None
    code = (out.get("status") or {}).get("code")
    explicit = isinstance(out.get("allowed"), bool)
    if status == 429 or code == 429:
        return (SHED if explicit else PROBLEM), out
    if code == 504:
        return (EXPIRED if explicit else PROBLEM), out
    return ACCEPTED, out


def normalize_deny_messages(out: dict) -> list:
    """Sorted violation messages with the webhook's
    ``[denied by <constraint>] `` prefix stripped — the form oracle
    verdicts compare against.  Empty for allowed responses."""
    if out.get("allowed"):
        return []
    return sorted(
        _DENY_PREFIX.sub("", m)
        for m in (out.get("status") or {}).get("message", "").split("\n")
        if m
    )


def verdict_matches(out: dict, want: Tuple[bool, list]) -> bool:
    """One accepted response against its oracle verdict
    ``(allowed, sorted_messages)`` — allow/deny AND rendered message
    bytes must agree."""
    allowed = out["allowed"]
    o_allowed, o_msgs = want
    if allowed != o_allowed:
        return False
    return allowed or normalize_deny_messages(out) == list(o_msgs)
