"""Resource-hygiene lints (rules: thread-leak, bare-join, listener-close,
start-guard).

The conftest leak fixture catches these at RUNTIME (a leaked non-daemon
thread hangs pytest; a leaked listener holds its port); these rules catch
the same classes statically, before a test has to die for them:

thread-leak     every `threading.Thread(...)` must either be
                `daemon=True` or be joined somewhere in the same file
                (a `stop()`-style owner).  A non-daemon thread nobody
                joins pins process exit forever.
bare-join       `t.join()` with no timeout waits unboundedly — a wedged
                worker (the wedge chaos class) then hangs shutdown.
                Join with a timeout and check `is_alive()` after
                (util.join_thread does both).  Zero-argument `.join()`
                is reliably a thread join: `str.join` always takes the
                iterable argument.
listener-close  a class that binds a socketserver listener must tear it
                down via util.close_listener / server_close somewhere in
                the same file — the idempotent-start contract
                (WebhookServer, MetricsExporter, HealthServer...).
start-guard     a `start()` method that creates a thread or listener
                must be idempotent: guard on (or tear down) the previous
                instance first.  A double start otherwise leaks the old
                thread/socket — the exact bug fixed on WebhookServer
               , HealthServer/ProfileServer.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .core import Finding, Module, Project, register_pass, register_rule

R_THREAD_LEAK = register_rule(
    "thread-leak",
    "a threading.Thread is neither daemon=True nor joined in this file",
)
R_BARE_JOIN = register_rule(
    "bare-join",
    "thread join without a timeout — a wedged thread hangs shutdown; "
    "use util.join_thread (join with timeout + liveness check)",
)
R_LISTENER = register_rule(
    "listener-close",
    "a socketserver listener is bound but never closed in this file "
    "(util.close_listener / server_close)",
)
R_START_GUARD = register_rule(
    "start-guard",
    "start() creates a thread/listener without guarding against a "
    "previous live one — a double start leaks it",
)

_THREAD_CTORS = ("threading.Thread", "_threading.Thread", "Thread")
_LISTENER_CTORS = (
    "ThreadingHTTPServer", "HTTPServer", "TCPServer", "UDPServer",
    "socketserver.TCPServer", "socketserver.ThreadingTCPServer",
    "http.server.ThreadingHTTPServer",
)


def _dotted(expr: ast.expr) -> Optional[str]:
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _kw(node: ast.Call, name: str) -> Optional[ast.expr]:
    for k in node.keywords:
        if k.arg == name:
            return k.value
    return None


def _thread_name(node: ast.Call) -> str:
    nm = _kw(node, "name")
    if isinstance(nm, ast.Constant) and isinstance(nm.value, str):
        return f" ({nm.value!r})"
    return ""


@register_pass
def hygiene_pass(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        if mod.tree is None:
            continue
        src = mod.source
        # thread-join detection must be AST-shaped like bare-join's:
        # a `.join` attribute call with zero positional args (str.join
        # always takes its iterable, os.path.join several) — a raw
        # substring test would let `", ".join(names)` anywhere in the
        # file silently disable thread-leak for the whole module.
        # join_thread(t, timeout, ...) is the util helper equivalent.
        has_join = False
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Call):
                continue
            if (
                isinstance(n.func, ast.Attribute)
                and n.func.attr == "join"
                and not n.args
            ):
                has_join = True
                break
            fname = getattr(n.func, "id", getattr(n.func, "attr", ""))
            if fname == "join_thread":
                has_join = True
                break
        closes_listener = (
            "close_listener" in src or "server_close" in src
        )

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)

            # ---- thread-leak ------------------------------------------------
            if d in _THREAD_CTORS:
                daemon = _kw(node, "daemon")
                is_daemon = (
                    isinstance(daemon, ast.Constant) and daemon.value is True
                )
                if not is_daemon and not has_join:
                    findings.append(mod.finding(
                        R_THREAD_LEAK, node.lineno,
                        "Thread" + _thread_name(node) + " is not "
                        "daemon=True and nothing in this file joins a "
                        "thread — it outlives (or hangs) process exit",
                    ))

            # ---- bare-join --------------------------------------------------
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and not node.args
                and not node.keywords
            ):
                findings.append(mod.finding(
                    R_BARE_JOIN, node.lineno,
                    f"`{_dotted(node.func) or 'thread.join'}()` without a "
                    "timeout — a wedged thread hangs the caller forever; "
                    "join with a timeout and handle is_alive() "
                    "(util.join_thread)",
                ))

            # ---- listener-close ---------------------------------------------
            if d is not None and (
                d in _LISTENER_CTORS
                or d.split(".")[-1] in ("ThreadingHTTPServer", "HTTPServer")
            ):
                if not closes_listener:
                    findings.append(mod.finding(
                        R_LISTENER, node.lineno,
                        f"{d} bound here but this file never closes a "
                        "listener (util.close_listener / server_close) — "
                        "the port leaks across restarts",
                    ))

        # ---- start-guard ----------------------------------------------------
        for cls_node in ast.walk(mod.tree):
            if not isinstance(cls_node, ast.ClassDef):
                continue
            for fn in cls_node.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                if fn.name not in ("start", "start_monitor", "serve"):
                    continue
                created: List[str] = []  # self-attrs assigned a thread/server
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Assign) and isinstance(
                        sub.value, ast.Call
                    ):
                        d = _dotted(sub.value.func) or ""
                        if d in _THREAD_CTORS or d in _LISTENER_CTORS or (
                            d.split(".")[-1] in (
                                "Thread", "ThreadingHTTPServer", "HTTPServer",
                            )
                        ):
                            for tgt in sub.targets:
                                td = _dotted(tgt)
                                if td and td.startswith("self."):
                                    created.append(td)
                if not created:
                    continue
                # guarded iff the method TESTS one of those attrs (an If
                # or a boolean/compare expression referencing it) before
                # or around creating the new one, or tears the old one
                # down via close_listener/shutdown/is_alive
                fn_src_names = set()
                for sub in ast.walk(fn):
                    if isinstance(sub, (ast.If, ast.IfExp)):
                        for name in ast.walk(sub.test):
                            dd = _dotted(name) if isinstance(
                                name, (ast.Attribute, ast.Name)
                            ) else None
                            if dd:
                                fn_src_names.add(dd)
                    if isinstance(sub, ast.Call):
                        dd = _dotted(sub.func) or ""
                        if dd.endswith("close_listener") or dd.endswith(
                            ".shutdown"
                        ) or dd.endswith(".is_alive"):
                            fn_src_names.add("__teardown__")
                guarded = "__teardown__" in fn_src_names or any(
                    attr in n or n in attr
                    for attr in created for n in fn_src_names
                )
                if not guarded:
                    findings.append(mod.finding(
                        R_START_GUARD, fn.lineno,
                        f"{cls_node.name}.{fn.name}() creates "
                        f"{', '.join(sorted(set(created)))} without "
                        "checking for a previous live one — a double "
                        "start leaks the old thread/listener (idempotent-"
                        "start contract, docs/static-analysis.md)",
                    ))
    return findings
