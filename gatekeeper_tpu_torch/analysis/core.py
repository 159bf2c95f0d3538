"""gklint core: project model, findings, suppressions, baseline.

The analyzer is deliberately import-free with respect to the code it
checks: every pass works on `ast` trees plus raw source text, so linting
the repo never initializes JAX, binds ports, or spawns threads.  A
"project" is the set of parsed modules under the paths handed to the CLI;
passes are either per-module (most rules) or whole-project (the lock-order
graph, the registry cross-checks).

Suppression contract (docs/static-analysis.md):

    x = risky()  # gklint: disable=rule-name -- why this is safe

A disable comment applies to findings on its own line, or — when the
comment stands alone — to the next source line (chains of comment lines
stack).  The ``-- reason`` is REQUIRED: a disable without one is itself a
finding (``suppression-reason``), so every suppression in the tree
carries its justification next to the code it excuses.

File-level escape hatch for generated/fixture files:

    # gklint: disable-file=rule-name -- reason

The committed baseline (.gklint-baseline.json at the repo root) absorbs
residual findings by (rule, path, enclosing-scope) key so the tree runs
clean at zero UNSUPPRESSED findings; `--write-baseline` regenerates it.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

# ---- findings ---------------------------------------------------------------

#: rule-id -> one-line description, populated by register_rule()
RULES: Dict[str, str] = {}


def register_rule(rule: str, doc: str) -> str:
    RULES[rule] = doc
    return rule


R_SUPPRESSION = register_rule(
    "suppression-reason",
    "a `# gklint: disable=` comment must carry a `-- reason`",
)
R_UNKNOWN_RULE = register_rule(
    "unknown-rule",
    "a `# gklint: disable=` comment names a rule that does not exist",
)


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    context: str = ""  # enclosing class.function qualname, "" at module level

    def key(self) -> tuple:
        # line numbers are deliberately NOT part of the identity: a
        # baseline must survive unrelated edits shifting code downward
        return (self.rule, self.path, self.context)

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        ctx = f" [{self.context}]" if self.context else ""
        return f"{where}: {self.rule}: {self.message}{ctx}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "context": self.context,
            "message": self.message,
        }


# ---- suppressions -----------------------------------------------------------

_DISABLE_RE = re.compile(
    r"gklint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\- ]+?)"
    r"\s*(?:--\s*(\S.*))?$"
)


@dataclass
class Suppression:
    rules: Set[str]
    reason: Optional[str]
    line: int
    standalone: bool  # comment is the only thing on its line


class SuppressionSet:
    """Per-file disable comments, resolved from the token stream (never
    from regexing raw lines — '#' inside string literals must not count)."""

    def __init__(self):
        self.by_line: Dict[int, Suppression] = {}
        self.file_rules: Set[str] = set()
        self.problems: List[tuple] = []  # (line, rule, message)
        # lines that are standalone comments (suppression or not): a
        # disable at the top of a multi-line comment block still covers
        # the statement below the block
        self.comment_lines: Set[int] = set()

    @classmethod
    def collect(cls, source: str) -> "SuppressionSet":
        out = cls()
        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
        except (tokenize.TokenError, SyntaxError, IndentationError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            if tok.line.strip().startswith("#"):
                out.comment_lines.add(tok.start[0])
            m = _DISABLE_RE.search(tok.string)
            if m is None:
                if "gklint:" in tok.string:
                    out.problems.append((
                        tok.start[0], R_SUPPRESSION,
                        "unparseable gklint comment "
                        "(want `# gklint: disable=<rule> -- <reason>`)",
                    ))
                continue
            kind, rules_s, reason = m.group(1), m.group(2), m.group(3)
            rules = {r.strip() for r in rules_s.split(",") if r.strip()}
            line = tok.start[0]
            for r in rules:
                if r not in RULES:
                    out.problems.append((
                        line, R_UNKNOWN_RULE,
                        f"disable names unknown rule {r!r} "
                        f"(see `gklint --list-rules`)",
                    ))
            if not reason:
                out.problems.append((
                    line, R_SUPPRESSION,
                    "suppression without a reason — append `-- <why>`",
                ))
                # an unreasoned disable still suppresses: the finding about
                # the missing reason is the enforcement, and double-reporting
                # the original would punish the annotated line twice
            standalone = tok.line.strip().startswith("#")
            if kind == "disable-file":
                out.file_rules |= rules
            else:
                prev = out.by_line.get(line)
                if prev is not None:
                    prev.rules |= rules
                else:
                    out.by_line[line] = Suppression(
                        rules, reason, line, standalone
                    )
        return out

    def active_rules_for(self, line: int) -> Set[str]:
        """Rules suppressed at `line`: file-level ones, a same-line
        disable, or a standalone-comment chain immediately above."""
        rules = set(self.file_rules)
        sup = self.by_line.get(line)
        if sup is not None:
            rules |= sup.rules
        probe = line - 1
        while probe > 0 and probe in self.comment_lines:
            sup = self.by_line.get(probe)
            if sup is not None and sup.standalone:
                rules |= sup.rules
            probe -= 1
        return rules

    def suppressed(self, finding: Finding) -> bool:
        return finding.rule in self.active_rules_for(finding.line)


# ---- module / project model -------------------------------------------------


class Module:
    """One parsed source file plus derived lookup structures."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.Module] = None
        self.syntax_error: Optional[str] = None
        try:
            self.tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:
            self.syntax_error = f"{e.msg} (line {e.lineno})"
        self.suppressions = SuppressionSet.collect(source)
        # name -> "pkg.mod.name" for `from X import name` (relative dots
        # collapsed); used to canonicalize shared locks like DISPATCH_LOCK
        self.import_origins: Dict[str, str] = {}
        # enclosing-scope map: (lineno -> qualname) resolved lazily
        self._scopes: Optional[List[tuple]] = None
        if self.tree is not None:
            self._collect_imports()

    # a stable module handle: path without .py, slashes -> dots
    @property
    def modname(self) -> str:
        rel = self.relpath[:-3] if self.relpath.endswith(".py") else self.relpath
        return rel.replace("/", ".")

    def _collect_imports(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    local = alias.asname or alias.name
                    self.import_origins[local] = (
                        f"{node.module}.{alias.name}"
                    )

    def scope_at(self, line: int) -> str:
        """Qualname of the innermost class/function containing `line`."""
        if self._scopes is None:
            spans: List[tuple] = []

            def visit(node, prefix):
                for child in ast.iter_child_nodes(node):
                    if isinstance(
                        child,
                        (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                    ):
                        qual = f"{prefix}{child.name}"
                        end = getattr(child, "end_lineno", child.lineno)
                        spans.append((child.lineno, end, qual))
                        visit(child, qual + ".")
                    else:
                        visit(child, prefix)

            if self.tree is not None:
                visit(self.tree, "")
            spans.sort(key=lambda s: (s[0], -s[1]))
            self._scopes = spans
        best = ""
        for lo, hi, qual in self._scopes:
            if lo <= line <= hi:
                best = qual  # spans sorted outer-first; keep innermost
        return best

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        line = (
            node_or_line
            if isinstance(node_or_line, int)
            else getattr(node_or_line, "lineno", 1)
        )
        return Finding(rule, self.relpath, line, message, self.scope_at(line))


class Project:
    """The analyzed file set.  `root` anchors repo-relative paths and the
    doc/registry cross-checks (docs/, faults/, catalog live under it)."""

    def __init__(self, root: str, modules: List[Module]):
        self.root = root
        self.modules = modules

    @classmethod
    def load(cls, root: str, paths: Sequence[str],
             exclude: Sequence[str] = ()) -> "Project":
        root = os.path.abspath(root)
        files: List[str] = []
        for p in paths:
            p = os.path.abspath(p)
            if os.path.isfile(p) and p.endswith(".py"):
                files.append(p)
            elif os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(
                        d for d in dirnames
                        if d != "__pycache__" and not d.startswith(".")
                    )
                    for f in sorted(filenames):
                        if f.endswith(".py"):
                            files.append(os.path.join(dirpath, f))
        seen = set()
        modules = []
        for f in files:
            if f in seen:
                continue
            seen.add(f)
            rel = os.path.relpath(f, root).replace(os.sep, "/")
            if any(rel.startswith(e) for e in exclude):
                continue
            try:
                with open(f, encoding="utf-8") as fh:
                    source = fh.read()
            except (OSError, UnicodeDecodeError):
                continue
            modules.append(Module(f, rel, source))
        return cls(root, modules)


# ---- pass registry ----------------------------------------------------------

#: callables Project -> Iterable[Finding]
PASSES: List[Callable[[Project], Iterable[Finding]]] = []


def register_pass(fn):
    PASSES.append(fn)
    return fn


def _suppression_findings(project: Project) -> List[Finding]:
    out = []
    for mod in project.modules:
        for line, rule, msg in mod.suppressions.problems:
            out.append(Finding(rule, mod.relpath, line, msg,
                               mod.scope_at(line)))
        if mod.syntax_error is not None:
            out.append(Finding(
                "unknown-rule", mod.relpath, 1,
                f"file does not parse: {mod.syntax_error}", "",
            ))
    return out


def run_passes(project: Project,
               select: Optional[Set[str]] = None) -> List[Finding]:
    """All raw findings (suppressions applied, baseline NOT applied)."""
    raw: List[Finding] = list(_suppression_findings(project))
    for p in PASSES:
        raw.extend(p(project))
    by_path = {m.relpath: m for m in project.modules}
    out = []
    for f in raw:
        if select is not None and f.rule not in select:
            continue
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressions.suppressed(f):
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


# ---- baseline ---------------------------------------------------------------

BASELINE_NAME = ".gklint-baseline.json"


def load_baseline(path: str) -> Dict[tuple, int]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    counts: Dict[tuple, int] = {}
    for entry in data.get("findings", []):
        key = (entry.get("rule", ""), entry.get("path", ""),
               entry.get("context", ""))
        counts[key] = counts.get(key, 0) + int(entry.get("count", 1))
    return counts


def write_baseline(path: str, findings: List[Finding]) -> None:
    counts: Dict[tuple, int] = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    entries = [
        {"rule": rule, "path": p, "context": ctx, "count": n}
        for (rule, p, ctx), n in sorted(counts.items())
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"comment": (
            "gklint baseline: accepted findings by (rule, path, context). "
            "Regenerate with `python tools/gklint.py --write-baseline`; "
            "prefer fixing or inline `# gklint: disable=... -- reason`."
        ), "findings": entries}, f, indent=2, sort_keys=True)
        f.write("\n")


def apply_baseline(findings: List[Finding],
                   baseline: Dict[tuple, int]) -> List[Finding]:
    budget = dict(baseline)
    out = []
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            continue
        out.append(f)
    return out
