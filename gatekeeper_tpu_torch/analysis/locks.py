"""Lock-order and hold-while-blocking analysis (rules: lock-order-cycle,
blocking-under-lock, cv-held-lock).

Motivating incidents (docs/static-analysis.md has the full catalog):

* the background delta-executable warm and a foreground sweep
  enqueued mesh collectives from different threads; the per-device launch
  orders interleaved and the AllReduce rendezvous deadlocked.  The fix
  (`parallel/mesh.py DISPATCH_LOCK`) is an ordering discipline — exactly
  the class of invariant a held-while-acquiring graph checks.
* `MicroBatcher._adapt()` ran under the batcher condition variable
  while the service model took the driver lock; a long driver hold
  (audit sweep) stalled every enqueue behind the cv.

Model: every `with <lock-like>:` body and `<lock-like>.acquire()` call is
an acquisition site.  Lock-like expressions are recognized by name
(`*_lock`, `_mu`, `_cv`, `_cond`, `*gate`, `DISPATCH_LOCK`, ...) and
canonicalized to a project-wide identity — `self._lock` in class C of
module m is `m.C._lock`; module globals resolve through `from X import`
chains so `DISPATCH_LOCK` is one node everywhere.  Per function we record

  - ordered pairs (held -> acquired) from nested acquisitions,
  - calls made while holding each lock.

A name-based call graph (self-methods to the same class, bare names to
the same module, unique method names across the project) then propagates
each function's may-acquire and may-block sets, which yields:

  lock-order-cycle    an edge participating in a held-while-acquiring
                      cycle (the ABBA deadlock shape)
  blocking-under-lock an UNBOUNDED blocking call (socket/pipe reads,
                      subprocess waits, `time.sleep`, `join()`/`wait()`
                      without timeout) reachable while a lock is held
  cv-held-lock        acquiring another lock while holding a condition
                      variable (the stall shape) — cv waits on the
                      cv itself are exempt (they release it)

Name-based resolution is deliberately conservative: unresolvable calls
contribute nothing, so every report points at a concrete chain.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Module, Project, register_pass, register_rule

R_CYCLE = register_rule(
    "lock-order-cycle",
    "locks are acquired in conflicting orders on different paths (ABBA "
    "deadlock shape)",
)
R_BLOCKING = register_rule(
    "blocking-under-lock",
    "an unbounded blocking call (pipe/socket read, subprocess wait, "
    "sleep, join()/wait() without timeout) runs while a lock is held",
)
R_CV_HELD = register_rule(
    "cv-held-lock",
    "another lock is acquired while a condition variable is held — a "
    "slow holder of the inner lock stalls every cv waiter (the stall shape)",
)

# terminal-name heuristic for lock-like attributes/globals
_LOCK_TERM = re.compile(r"(?:^|_)(lock|mu|cv|cond|gate)$", re.IGNORECASE)
# condition variables, for the cv-held-lock rule
_CV_TERM = re.compile(r"(?:^|_)(cv|cond)$", re.IGNORECASE)

# attribute calls that block unboundedly regardless of arguments
_BLOCKING_ATTRS = {
    "readline": "pipe/socket read",
    "readlines": "pipe/socket read",
    "recv": "socket read",
    "recvfrom": "socket read",
    "accept": "socket accept",
    "connect": "socket connect",
    "communicate": "subprocess wait",
    "check_output": "subprocess wait",
    "check_call": "subprocess wait",
    "urlopen": "HTTP round trip",
    "getresponse": "HTTP round trip",
    "block_until_ready": "device sync",
}
# modules whose .run/.call are subprocess entry points
_SUBPROCESS_BASES = {"subprocess", "_subprocess", "sp"}

# attribute-call names too ubiquitous for unique-name resolution: nearly
# every one shadows a stdlib method (Event.set, Queue.get, dict.update,
# Thread.start...), so "defined by exactly one class in the project"
# proves nothing about the receiver
_COMMON_METHODS = {
    "set", "get", "put", "clear", "pop", "append", "add", "remove",
    "discard", "update", "copy", "items", "keys", "values", "read",
    "write", "flush", "close", "open", "send", "start", "stop", "run",
    "join", "wait", "notify", "notify_all", "acquire", "release",
    "submit", "result", "cancel", "done", "next", "reset", "handle",
}

# the fault plane's sleep/hang IS the injected fault, not a real blocking
# call on the production path — its latency propagating through every
# `faults.fire()` call site would flag half the repo
_FAULT_MODULES = ("gatekeeper_tpu_torch/faults/",)


def _dotted(expr: ast.expr) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_cv(lock_id: str) -> bool:
    return bool(_CV_TERM.search(lock_id.rsplit(".", 1)[-1]))


@dataclass
class _Call:
    held: Tuple[str, ...]
    target: Optional[str]  # resolution key, see _FnCollector._target
    line: int
    module: Module


@dataclass
class _Block:
    held: Tuple[str, ...]
    what: str
    line: int
    module: Module


@dataclass
class _FnSummary:
    qual: str  # modname::Class.method
    module: Module
    cls: Optional[str]
    name: str
    direct: Set[str] = field(default_factory=set)
    # (held, acquired, line) pairs from nested acquisition
    order: List[Tuple[str, str, int]] = field(default_factory=list)
    calls: List[_Call] = field(default_factory=list)
    blocking: List[_Block] = field(default_factory=list)
    # blocking calls made with NO lock held — matter only transitively
    blocks_bare: List[Tuple[str, int]] = field(default_factory=list)


class _FnCollector(ast.NodeVisitor):
    """Single-function walker carrying the held-lock stack."""

    def __init__(self, summary: _FnSummary, module: Module):
        self.s = summary
        self.module = module
        self.held: List[str] = []

    # -- lock identity --------------------------------------------------------

    def _lock_id(self, expr: ast.expr) -> Optional[str]:
        dotted = _dotted(expr)
        if dotted is None:
            return None
        term = dotted.rsplit(".", 1)[-1]
        if not _LOCK_TERM.search(term):
            return None
        mod = self.module
        if "." not in dotted:  # module-global (or local) name
            origin = mod.import_origins.get(dotted)
            return origin if origin else f"{mod.modname}.{dotted}"
        base, rest = dotted.split(".", 1)
        if base == "self" and self.s.cls:
            return f"{mod.modname}.{self.s.cls}.{rest}"
        origin = mod.import_origins.get(base)
        if origin:
            return f"{origin}.{rest}"
        return f"{mod.modname}.{base}.{rest}"

    def _note_acquire(self, lock_id: str, line: int):
        for held in self.held:
            if held != lock_id:
                self.s.order.append((held, lock_id, line))
        self.s.direct.add(lock_id)

    # -- call classification ---------------------------------------------------

    def _target(self, func: ast.expr) -> Optional[str]:
        """Resolution key: 'self::name' | 'mod::name' | 'any::name'."""
        if isinstance(func, ast.Name):
            origin = self.module.import_origins.get(func.id)
            if origin:
                return f"import::{origin}"
            return f"mod::{self.module.modname}::{func.id}"
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                return (
                    f"self::{self.module.modname}::{self.s.cls}"
                    f"::{func.attr}"
                )
            return f"any::{func.attr}"
        return None

    def _blocking_reason(self, node: ast.Call) -> Optional[str]:
        func = node.func
        kw = {k.arg for k in node.keywords}
        if isinstance(func, ast.Attribute):
            attr = func.attr
            if attr in _BLOCKING_ATTRS:
                return _BLOCKING_ATTRS[attr]
            base = _dotted(func.value)
            if attr == "sleep" and base in ("time", "_time"):
                return "time.sleep"
            if attr in ("run", "call") and base in _SUBPROCESS_BASES:
                return "subprocess wait"
            if attr == "join" and not node.args and "timeout" not in kw:
                # zero-arg join is a thread join (str.join always takes
                # an argument); without timeout it waits forever
                return "join() without timeout"
            if attr == "wait" and not node.args and "timeout" not in kw:
                # Event/Condition/Popen wait without a bound.  Waiting on
                # a cv that is itself the (innermost) held lock releases
                # it — the canonical pattern — so only flag waits on
                # OTHER objects.
                rid = self._lock_id(func.value)
                if rid is None or rid not in self.held:
                    return "wait() without timeout"
            return None
        if isinstance(func, ast.Name):
            origin = self.module.import_origins.get(func.id, "")
            if func.id == "sleep" and origin == "time.sleep":
                return "time.sleep"
            if origin in ("urllib.request.urlopen",):
                return "HTTP round trip"
        return None

    # -- traversal -------------------------------------------------------------

    def visit_With(self, node: ast.With):
        acquired: List[str] = []
        for item in node.items:
            lid = self._lock_id(item.context_expr)
            if lid is not None:
                self._note_acquire(lid, node.lineno)
                self.held.append(lid)
                acquired.append(lid)
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call):
        func = node.func
        # explicit .acquire() on a lock-like object counts as an
        # acquisition event for ordering (DispatchGate token style)
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            lid = self._lock_id(func.value)
            if lid is not None:
                self._note_acquire(lid, node.lineno)
        reason = self._blocking_reason(node)
        if reason is not None:
            if self.held and "blocking-under-lock" not in (
                self.module.suppressions.active_rules_for(node.lineno)
            ):
                self.s.blocking.append(_Block(
                    tuple(self.held), reason, node.lineno, self.module
                ))
            elif not self.held:
                self.s.blocks_bare.append((reason, node.lineno))
        target = self._target(func)
        if target is not None:
            self.s.calls.append(_Call(
                tuple(self.held), target, node.lineno, self.module
            ))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # nested defs analyzed separately
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):  # lambda bodies run later, not here
        return


def _collect_functions(project: Project) -> List[_FnSummary]:
    out: List[_FnSummary] = []
    for mod in project.modules:
        if mod.tree is None:
            continue

        def walk(node, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qual = (
                        f"{mod.modname}::{cls}.{child.name}"
                        if cls else f"{mod.modname}::{child.name}"
                    )
                    s = _FnSummary(qual, mod, cls, child.name)
                    coll = _FnCollector(s, mod)
                    for stmt in child.body:
                        coll.visit(stmt)
                    out.append(s)
                    # nested defs (closures, thread bodies) get their own
                    # summaries under the same class context
                    walk(child, cls)
                else:
                    walk(child, cls)

        walk(mod.tree, None)
    return out


class _Resolver:
    def __init__(self, fns: List[_FnSummary]):
        self.by_qual = {f.qual: f for f in fns}
        self.by_mod_name: Dict[Tuple[str, str], str] = {}
        self.by_cls_name: Dict[Tuple[str, str, str], str] = {}
        self.by_name: Dict[str, List[str]] = {}
        for f in fns:
            if f.cls is None:
                self.by_mod_name[(f.module.modname, f.name)] = f.qual
            else:
                self.by_cls_name[(f.module.modname, f.cls, f.name)] = f.qual
            self.by_name.setdefault(f.name, []).append(f.qual)

    def resolve(self, target: str) -> Optional[str]:
        kind, _, rest = target.partition("::")
        if kind == "self":
            modname, _, rest2 = rest.partition("::")
            cls, _, name = rest2.partition("::")
            return self.by_cls_name.get((modname, cls, name))
        if kind == "mod":
            modname, _, name = rest.partition("::")
            return self.by_mod_name.get((modname, name))
        if kind == "import":
            # 'pkg.mod.func' -> module-level function in an analyzed module
            if "." in rest:
                modpath, name = rest.rsplit(".", 1)
                for (m, n), qual in self.by_mod_name.items():
                    if n == name and (
                        m == modpath or m.endswith("/" + modpath)
                        or m.endswith("." + modpath) or modpath.endswith(m)
                    ):
                        return qual
            return None
        if kind == "any":
            # attribute call on an unknown object: resolve only when the
            # method name is defined by exactly ONE class in the project
            # AND does not shadow a ubiquitous stdlib method — anything
            # more aggressive invents call edges
            if rest in _COMMON_METHODS:
                return None
            quals = [
                q for q in self.by_name.get(rest, ())
                if self.by_qual[q].cls is not None
            ]
            if len(quals) == 1:
                return quals[0]
        return None


def _fixpoint(fns: List[_FnSummary], resolver: _Resolver):
    """Propagate may-acquire lock sets and may-block reasons through the
    call graph to a fixpoint."""
    may_acquire: Dict[str, Set[str]] = {f.qual: set(f.direct) for f in fns}

    def _injects_only(f: _FnSummary) -> bool:
        return any(
            f.module.relpath.startswith(p) for p in _FAULT_MODULES
        )

    may_block: Dict[str, Set[str]] = {
        f.qual: (
            set() if _injects_only(f)
            else {w for (w, _ln) in f.blocks_bare}
            | {b.what for b in f.blocking}
        )
        for f in fns
    }
    edges: Dict[str, Set[str]] = {}
    for f in fns:
        for c in f.calls:
            callee = resolver.resolve(c.target)
            if callee is not None and callee != f.qual:
                edges.setdefault(f.qual, set()).add(callee)
    for _ in range(30):  # deep chains converge far earlier
        changed = False
        for f in fns:
            for callee in edges.get(f.qual, ()):
                before = len(may_acquire[f.qual])
                may_acquire[f.qual] |= may_acquire[callee]
                if len(may_acquire[f.qual]) != before:
                    changed = True
                before = len(may_block[f.qual])
                may_block[f.qual] |= may_block[callee]
                if len(may_block[f.qual]) != before:
                    changed = True
        if not changed:
            break
    return may_acquire, may_block


@register_pass
def lock_pass(project: Project) -> List[Finding]:
    fns = _collect_functions(project)
    resolver = _Resolver(fns)
    may_acquire, may_block = _fixpoint(fns, resolver)

    # ---- edge set: direct nesting + call-propagated acquisitions ----------
    # edge -> (module, line, via) of one representative site
    edge_sites: Dict[Tuple[str, str], Tuple[Module, int, str]] = {}
    for f in fns:
        for held, acq, line in f.order:
            edge_sites.setdefault((held, acq), (f.module, line, ""))
        for c in f.calls:
            if not c.held:
                continue
            callee = resolver.resolve(c.target)
            if callee is None:
                continue
            for acq in may_acquire[callee]:
                for held in c.held:
                    if held != acq:
                        edge_sites.setdefault(
                            (held, acq),
                            (c.module, c.line, callee.split("::")[-1]),
                        )

    findings: List[Finding] = []

    # ---- lock-order cycles (Tarjan SCC over the lock digraph) -------------
    adj: Dict[str, Set[str]] = {}
    for (a, b) in edge_sites:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[Set[str]] = []
    counter = [0]

    def strongconnect(v: str):
        # iterative Tarjan: the lock graph is small but recursion depth
        # must not depend on it
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    for scc in sccs:
        if len(scc) < 2:
            continue
        members = " <-> ".join(sorted(scc))
        for (a, b), (mod, line, via) in sorted(edge_sites.items()):
            if a in scc and b in scc:
                hop = f" (via {via}())" if via else ""
                findings.append(mod.finding(
                    R_CYCLE, line,
                    f"acquires {b} while holding {a}{hop}, but the "
                    f"opposite order also exists — deadlock cycle over "
                    f"{{{members}}}",
                ))

    # ---- cv-held-lock (the stall shape) ------------------------------
    for (held, acq), (mod, line, via) in sorted(edge_sites.items()):
        if _is_cv(held) and not _is_cv(acq):
            hop = f" via {via}()" if via else ""
            findings.append(mod.finding(
                R_CV_HELD, line,
                f"acquires {acq}{hop} while holding condition variable "
                f"{held} — a slow holder of the inner lock stalls every "
                "cv waiter; restructure so the cv only guards queue "
                "state (see MicroBatcher._adapt, docs/static-analysis.md)",
            ))

    # ---- blocking-under-lock ----------------------------------------------
    for f in fns:
        for b in f.blocking:
            findings.append(b.module.finding(
                R_BLOCKING, b.line,
                f"{b.what} while holding {', '.join(b.held)} — bound it "
                "with a timeout or move it outside the critical section",
            ))
        for c in f.calls:
            if not c.held:
                continue
            callee = resolver.resolve(c.target)
            if callee is None:
                continue
            for what in sorted(may_block[callee]):
                findings.append(c.module.finding(
                    R_BLOCKING, c.line,
                    f"call to {callee.split('::')[-1]}() may perform "
                    f"{what} while holding {', '.join(c.held)}",
                ))
    return findings
