"""Fail-open/closed audit (rule: swallowed-exception).

Earlier work made admission failure an EXPLICIT decision: when the deadline
budget is exhausted or a backend fails, `ValidationHandler` routes
through the configured fail-open/fail-closed policy and records the
outcome.  A `except Exception: pass` on those paths silently converts a
backend failure into... nothing — on the admission path that's an
implicit fail-open nobody chose; on the audit path it's a sweep that
"succeeded" with missing violations.

The rule: an exception handler that catches broadly (bare `except:`,
`except Exception`, `except BaseException`) and whose body does NOTHING
— only `pass`/`...`/`continue` — is flagged.  Handlers that log, record
a metric, set state, return a value, or re-raise are fine: the point is
that SOMETHING observable must happen.  On modules outside the
admission/audit path the rule still applies (a silent swallow is never
load-bearing), but the message names the policy routing only for path
modules.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, Project, register_pass, register_rule

R_SWALLOW = register_rule(
    "swallowed-exception",
    "a broad except handler silently swallows (body is only pass/"
    "continue) — route through the explicit fail-open/closed decision "
    "or at least log",
)

# repo-relative prefixes where a swallow is an admission/audit policy bug
_PATH_PREFIXES = (
    "gatekeeper_tpu_torch/webhook/", "gatekeeper_tpu_torch/audit/",
    "gatekeeper_tpu_torch/deadline.py", "gatekeeper_tpu_torch/ops/driver.py",
    "gatekeeper_tpu_torch/fleet/",
)

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    names = []
    if isinstance(t, ast.Tuple):
        names = [getattr(e, "id", getattr(e, "attr", "")) for e in t.elts]
    else:
        names = [getattr(t, "id", getattr(t, "attr", ""))]
    return any(n in _BROAD for n in names)


def _is_silent(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(
            stmt.value, ast.Constant
        ):
            continue  # docstring / ellipsis
        return False
    return True


@register_pass
def fail_policy_pass(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        if mod.tree is None:
            continue
        on_path = any(mod.relpath.startswith(p) for p in _PATH_PREFIXES)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not (_is_broad(node) and _is_silent(node)):
                continue
            if on_path:
                msg = (
                    "broad except silently swallows on an admission/audit "
                    "path — failures here must route through the explicit "
                    "deadline fail-open/closed decision (deadline.py, "
                    "docs/failure-modes.md), or at least log and count"
                )
            else:
                msg = (
                    "broad except with an empty body silently swallows — "
                    "log, count, or narrow the exception type"
                )
            findings.append(mod.finding(R_SWALLOW, node.lineno, msg))
    return findings
