"""Event-loop socket discipline (rule: blocking-socket-in-loop).

A selectors-based reactor serves every connection from ONE thread: a
single blocking socket call on that thread parks the whole edge — every
pipelined client, every wire backend, the timer wheel — behind one slow
peer.  That is the exact failure the event-loop rewrite exists to
remove, and it regresses silently: the code still works on a warm
loopback bench and collapses under the first stalled peer in
production.

This pass machine-checks the discipline inside event-loop modules (any
module that imports ``selectors``):

blocking-socket-in-loop
    (1) ``.sendall(...)`` / ``.makefile(...)`` anywhere in the module —
    ``sendall`` spins/blocks until the kernel drains the buffer (the
    reactor must buffer and wait for EVENT_WRITE instead), and
    ``makefile`` wraps the socket in blocking file I/O.
    (2) ``.recv/.recv_into/.accept/.send/.connect(...)`` on a receiver
    with no non-blocking evidence in the module: the receiver's
    terminal name (leading underscores stripped, so ``self._lsock``
    matches ``lsock``) never received ``.setblocking(False)`` and never
    appears as the first argument to a ``*.register(...)`` /
    ``*.modify(...)`` selector call.  ``connect_ex`` is the sanctioned
    non-blocking connect and is not flagged.

Name-based evidence is deliberately coarse but errs quiet: any
``setblocking(False)`` or selector registration of the same terminal
name anywhere in the module clears that name.  Genuine off-loop helpers
inside an event-loop module (a probe thread, a test shim) carry
reasoned ``# gklint: disable=blocking-socket-in-loop`` suppressions —
which is exactly the "this runs off-loop because..." documentation the
next reader needs.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import Finding, Project, register_pass, register_rule

R_BLOCKING_SOCKET = register_rule(
    "blocking-socket-in-loop",
    "a blocking socket call inside an event-loop module — one stalled "
    "peer parks the whole reactor; use the non-blocking Conn/selector "
    "machinery (or justify an off-loop helper with a suppression)",
)

# always wrong in an event-loop module, no receiver analysis needed
_ALWAYS = {
    "sendall": "blocks until the kernel drains the send buffer — "
               "buffer the bytes and wait for EVENT_WRITE",
    "makefile": "wraps the socket in blocking file I/O",
}

# blocking unless the receiver has non-blocking evidence
_GUARDED = ("recv", "recv_into", "recvfrom", "accept", "send", "connect")


def _terminal(expr: ast.expr) -> Optional[str]:
    """Normalized terminal name of a Name/Attribute receiver chain:
    ``self._lsock`` -> ``lsock``, ``sock`` -> ``sock``."""
    if isinstance(expr, ast.Attribute):
        return expr.attr.lstrip("_") or None
    if isinstance(expr, ast.Name):
        return expr.id.lstrip("_") or None
    return None


def _imports_selectors(mod) -> bool:
    if mod.tree is None:
        return False
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "selectors"
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "selectors":
                return True
    return False


def _nonblocking_names(tree: ast.AST) -> Set[str]:
    """Terminal receiver names with non-blocking evidence: given
    ``.setblocking(False)``, or registered with a selector via
    ``*.register(x, ...)`` / ``*.modify(x, ...)``."""
    safe: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute):
            continue
        if fn.attr == "setblocking" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and arg.value is False:
                name = _terminal(fn.value)
                if name:
                    safe.add(name)
        elif fn.attr in ("register", "modify") and node.args:
            name = _terminal(node.args[0])
            if name:
                safe.add(name)
    return safe


@register_pass
def evloopsafety_pass(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        if mod.tree is None or not _imports_selectors(mod):
            continue
        safe = _nonblocking_names(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr in _ALWAYS:
                findings.append(mod.finding(
                    R_BLOCKING_SOCKET, node.lineno,
                    f".{fn.attr}() in an event-loop module: "
                    f"{_ALWAYS[fn.attr]}",
                ))
                continue
            if fn.attr not in _GUARDED:
                continue
            name = _terminal(fn.value)
            if name is not None and name in safe:
                continue
            findings.append(mod.finding(
                R_BLOCKING_SOCKET, node.lineno,
                f".{fn.attr}() on {name or 'an expression'!s} with no "
                "setblocking(False)/selector registration in this "
                "module — a blocking call here parks the reactor",
            ))
    return findings
