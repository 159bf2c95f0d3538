"""Structured logging with the reference's stable keys
(pkg/logging/logging.go:3-22) over stdlib logging, JSON-rendered.

Violation/deny events from the webhook and audit manager log through
`log_event` with these keys so downstream tooling can parse them the same
way it parses the reference's zap output.
"""

from __future__ import annotations

import json
import logging
import sys
import time

# logging.go:3-22 — stable structured keys
PROCESS = "process"
DETAILS = "details"
EVENT_TYPE = "event_type"
TEMPLATE_NAME = "template_name"
CONSTRAINT_GROUP = "constraint_group"
CONSTRAINT_API_VERSION = "constraint_api_version"
CONSTRAINT_KIND = "constraint_kind"
CONSTRAINT_NAME = "constraint_name"
CONSTRAINT_NAMESPACE = "constraint_namespace"
CONSTRAINT_ACTION = "constraint_action"
AUDIT_ID = "audit_id"
CONSTRAINT_STATUS = "constraint_status"
RESOURCE_GROUP = "resource_group"
RESOURCE_API_VERSION = "resource_api_version"
RESOURCE_KIND = "resource_kind"
RESOURCE_NAMESPACE = "resource_namespace"
RESOURCE_NAME = "resource_name"
REQUEST_USERNAME = "request_username"
# observability addition: every structured event carries the active trace
# id when one exists, so a deny log line correlates with its
# /debug/traces entry (and the upstream traceparent)
TRACE_ID = "trace_id"


# level encoders, matching zapcore's set (reference main.go:74-79)
_ANSI = {"debug": "\x1b[35m", "info": "\x1b[34m", "warning": "\x1b[33m",
         "error": "\x1b[31m", "critical": "\x1b[31m"}
LEVEL_ENCODERS = {
    "lower": lambda lv: lv.lower(),
    "capital": lambda lv: lv.upper(),
    "color": lambda lv: f"{_ANSI.get(lv.lower(), '')}{lv.lower()}\x1b[0m",
    "capitalcolor": lambda lv: f"{_ANSI.get(lv.lower(), '')}{lv.upper()}\x1b[0m",
}


class JsonFormatter(logging.Formatter):
    def __init__(self, level_key: str = "level", level_encoder: str = "lower"):
        super().__init__()
        self.level_key = level_key
        self.level_encoder = LEVEL_ENCODERS[level_encoder]

    def format(self, record: logging.LogRecord) -> str:
        out = {
            self.level_key: self.level_encoder(record.levelname),
            "ts": time.time(),  # wall-clock: ok (log record timestamp)
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "kv", None)
        if extra:
            out.update(extra)
        if record.exc_info:
            out["error"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup(
    level: str = "INFO",
    stream=None,
    level_key: str = "level",
    level_encoder: str = "lower",
) -> logging.Logger:
    """Process-wide JSON logger (the reference's zap setup, main.go:121-136;
    --log-level-key / --log-level-encoder mirror main.go:84-85)."""
    if level_encoder not in LEVEL_ENCODERS:
        raise ValueError(f"invalid log level encoder: {level_encoder}")
    root = logging.getLogger("gatekeeper")
    root.setLevel(level.upper())
    if not root.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(JsonFormatter(level_key, level_encoder))
        root.addHandler(h)
        root.propagate = False
    else:
        # re-setup (second App in one process, flag-configured key/encoder
        # after a default setup): apply the new format to the existing
        # handler instead of silently keeping the old one
        root.handlers[0].setFormatter(JsonFormatter(level_key, level_encoder))
    return root


def get(name: str) -> logging.Logger:
    return logging.getLogger(f"gatekeeper.{name}")


def log_event(logger: logging.Logger, msg: str, level: int = logging.INFO, **kv):
    """Structured log line with stable keys (e.g. violation_audited,
    admission deny — reference policy.go:241-257, audit/manager.go:732-750).
    The active trace id (obs.trace context) is injected automatically so
    violation/deny lines correlate with their trace."""
    if TRACE_ID not in kv:
        tid = _current_trace_id()
        if tid is not None:
            kv[TRACE_ID] = tid
    logger.log(level, msg, extra={"kv": kv})


# imported last: obs.trace depends only on the stdlib, so this cannot
# cycle back into this module
from .obs.trace import current_trace_id as _current_trace_id  # noqa: E402
