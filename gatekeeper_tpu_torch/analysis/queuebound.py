"""Unbounded-queue lint (rule: unbounded-queue).

The congestive-collapse recipe is always the same: a serving path
accepts work faster than it can finish it, and the buffer between the
two grows without bound until latency (then memory) dies.  The overload
plane bounds the repo's serving queues (micro-batcher ``max_pending``,
the front door's per-backend inflight cap); this pass keeps them
bounded — and keeps NEW queues from shipping unbounded by default:

unbounded-queue   (1) any ``queue.Queue()`` / ``SimpleQueue()``
                  constructed without a positive ``maxsize`` —
                  repo-wide, because an unbounded channel is a latent
                  collapse point wherever it sits.  By-design unbounded
                  sites (the watch event pump, the replica command
                  demux) carry reasoned inline suppressions, which is
                  exactly the documentation they were missing.
                  (2) on SERVING-PATH modules (webhook/, fleet/): a
                  ``self.<name> = []`` attribute whose name says it is a
                  queue (pending/backlog/queue) with no visible bound —
                  no ``len(self.<name>)`` comparison anywhere in the
                  class.  The list the micro-batcher queues requests on
                  is the exact object that grew without bound
                  before it was bounded.

The list heuristic is deliberately scoped to the serving tree: a
scratch list named ``pending`` in the audit packer is bounded by its
input; the same list on the admission path is bounded by nothing but
client patience.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .core import Finding, Project, register_pass, register_rule

R_UNBOUNDED_QUEUE = register_rule(
    "unbounded-queue",
    "a queue with no bound on (or near) a serving path — the congestive-"
    "collapse buffer; give it a maxsize / len() bound or a reasoned "
    "suppression",
)

# queue constructors that take maxsize (Queue/LifoQueue/PriorityQueue)
# or are unbounded by construction (SimpleQueue)
_SIZED_QUEUE_CTORS = ("Queue", "LifoQueue", "PriorityQueue")
_UNSIZED_QUEUE_CTORS = ("SimpleQueue",)

# serving-path prefixes for the list-attribute heuristic
_SERVING_PREFIXES = (
    "gatekeeper_tpu_torch/webhook/",
    "gatekeeper_tpu_torch/fleet/",
)

# attribute names that declare queue intent
_QUEUEY_NAMES = ("pending", "backlog", "queue")


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


def _queue_ctor_kind(call: ast.Call) -> Optional[str]:
    """'sized' for Queue-family ctors, 'unsized' for SimpleQueue, None
    for anything else.  Matches both bare names (from queue import
    Queue) and dotted ones (queue.Queue, _queue.Queue)."""
    d = _dotted(call.func)
    if d is None:
        return None
    leaf = d.split(".")[-1]
    if leaf in _SIZED_QUEUE_CTORS:
        return "sized"
    if leaf in _UNSIZED_QUEUE_CTORS:
        return "unsized"
    return None


def _has_positive_maxsize(call: ast.Call) -> bool:
    """True when the ctor passes a maxsize that is not literally 0
    (queue.Queue treats 0 / negative as infinite; a non-constant value
    is given the benefit of the doubt — the bound exists, its value is
    config)."""
    candidates: List[ast.expr] = []
    if call.args:
        candidates.append(call.args[0])
    for kw in call.keywords:
        if kw.arg == "maxsize":
            candidates.append(kw.value)
    for c in candidates:
        if isinstance(c, ast.Constant):
            if isinstance(c.value, (int, float)) and c.value > 0:
                return True
            continue  # literal 0/None: explicitly unbounded
        return True  # computed bound: accept
    return False


def _self_attr_of_len_compare(node: ast.Compare) -> List[str]:
    """self-attribute names appearing inside len(self.X) on either side
    of a comparison — the visible-bound evidence."""
    out: List[str] = []
    for side in [node.left, *node.comparators]:
        for sub in ast.walk(side):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == "len"
                and sub.args
            ):
                d = _dotted(sub.args[0])
                if d and d.startswith("self."):
                    out.append(d[len("self."):])
    return out


def _is_queuey(name: str) -> bool:
    low = name.lower()
    return any(q in low for q in _QUEUEY_NAMES)


@register_pass
def queuebound_pass(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        if mod.tree is None:
            continue

        # ---- (1) queue.Queue() without a positive maxsize, repo-wide --------
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _queue_ctor_kind(node)
            if kind is None:
                continue
            d = _dotted(node.func) or "Queue"
            if kind == "unsized":
                findings.append(mod.finding(
                    R_UNBOUNDED_QUEUE, node.lineno,
                    f"{d}() is unbounded by construction — use a "
                    "maxsize-bounded Queue (or justify with a reasoned "
                    "suppression)",
                ))
            elif not _has_positive_maxsize(node):
                findings.append(mod.finding(
                    R_UNBOUNDED_QUEUE, node.lineno,
                    f"{d}() without a positive maxsize is an unbounded "
                    "buffer — the congestive-collapse shape; bound it "
                    "or justify with a reasoned suppression",
                ))

        # ---- (2) list-backed pending queues on serving paths ----------------
        if not any(mod.relpath.startswith(p) for p in _SERVING_PREFIXES):
            continue
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            # attr name -> first assignment line of a list literal
            listy: dict = {}
            bounded: set = set()
            for sub in ast.walk(cls):
                target = None
                value = None
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    target, value = sub.targets[0], sub.value
                elif isinstance(sub, ast.AnnAssign):
                    target, value = sub.target, sub.value
                if target is not None and isinstance(value, ast.List):
                    d = _dotted(target)
                    if d and d.startswith("self."):
                        attr = d[len("self."):]
                        if _is_queuey(attr):
                            listy.setdefault(attr, sub.lineno)
                if isinstance(sub, ast.Compare):
                    bounded.update(_self_attr_of_len_compare(sub))
            for attr, lineno in sorted(listy.items()):
                if attr in bounded:
                    continue
                findings.append(mod.finding(
                    R_UNBOUNDED_QUEUE, lineno,
                    f"{cls.name}.{attr} is a list-backed queue on a "
                    "serving path with no visible bound (no "
                    f"len(self.{attr}) comparison in the class) — cap "
                    "it like MicroBatcher.max_pending or justify with "
                    "a reasoned suppression",
                ))
    return findings
