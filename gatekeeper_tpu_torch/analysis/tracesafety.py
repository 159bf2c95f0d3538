"""JAX trace-safety lints (rules: tracer-truthiness, jit-in-loop,
impure-in-jit).

Inside a `jax.jit` / `shard_map` region the array arguments are tracers:

* Python truthiness (`if x:`, `while x:`, `assert x`) and scalar
  coercion (`bool()`/`float()`/`int()`) on a traced value raise
  `TracerBoolConversionError`/`ConcretizationTypeError` at trace time —
  or worse, silently bake in a branch when the value is concrete during
  tests but traced in production (`tracer-truthiness`).
* Constructing a jit wrapper inside a loop recompiles (or at minimum
  re-hashes and cache-probes) every iteration; jit objects belong at
  module/closure scope (`jit-in-loop`).
* Wall-clock and RNG calls inside a compiled region execute ONCE at
  trace time and then freeze into the executable — a seeded
  `np.random` draw or `time.time()` stamp inside a kernel is a latent
  staleness bug (`impure-in-jit`).

Jitted regions are found syntactically: `@jax.jit` / `@jit` /
`@partial(jax.jit, ...)` decorators, `g = jax.jit(f)` /
`shard_map(f, ...)` wrapping of a function defined in the same module,
and inline `jax.jit(lambda ...)`.  Truthiness tracking is a single
forward pass: parameters seed the tainted set, assignments propagate it,
and shape-space accessors (`.shape`, `.ndim`, `.dtype`, `len()`) kill
it, since those are static under tracing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import Finding, Module, Project, register_pass, register_rule

R_TRUTHY = register_rule(
    "tracer-truthiness",
    "Python truthiness or bool/int/float() on a traced value inside a "
    "jit/shard_map region",
)
R_JIT_LOOP = register_rule(
    "jit-in-loop",
    "jax.jit(...) constructed inside a loop — hoist the wrapper out",
)
R_IMPURE = register_rule(
    "impure-in-jit",
    "wall-clock/RNG call inside a compiled region freezes at trace time",
)

# attribute accesses that are static under tracing (shape space)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "at"}
_SCALARIZERS = {"bool", "float", "int", "complex"}
_IMPURE_DOTTED = (
    "time.time", "time.monotonic", "time.perf_counter", "_time.time",
    "_time.monotonic", "_time.perf_counter", "datetime.now",
    "datetime.datetime.now", "random.random", "random.randint",
    "random.choice", "random.shuffle", "np.random", "numpy.random",
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


def _is_jit_callable(func: ast.expr) -> bool:
    """jax.jit / jit / partial(jax.jit, ...) as a callable expression."""
    d = _dotted(func)
    if d in ("jax.jit", "jit", "pjit", "jax.pjit"):
        return True
    if isinstance(func, ast.Call):
        fd = _dotted(func.func)
        if fd in ("partial", "functools.partial") and func.args:
            return _is_jit_callable(func.args[0])
    return False


def _is_shard_map(func: ast.expr) -> bool:
    d = _dotted(func) or ""
    return d.split(".")[-1] == "shard_map"


def _jitted_function_defs(mod: Module) -> Dict[str, ast.FunctionDef]:
    """name -> FunctionDef for every function in the module that is
    decorated as, or wrapped into, a jit/shard_map region."""
    defs: Dict[str, ast.FunctionDef] = {}
    by_name: Dict[int, Dict[str, ast.FunctionDef]] = {}

    # collect all function defs per enclosing scope id so `jax.jit(f)`
    # can resolve `f` defined as a sibling (module level or closure)
    def collect(node, scope_key):
        local = by_name.setdefault(scope_key, {})
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local[child.name] = child
                collect(child, id(child))
            elif isinstance(child, ast.ClassDef):
                collect(child, id(child))
            else:
                collect(child, scope_key)

    collect(mod.tree, id(mod.tree))

    # decorated defs
    for scope in by_name.values():
        for name, fn in scope.items():
            for dec in fn.decorator_list:
                if _is_jit_callable(dec) or (
                    isinstance(dec, ast.Call)
                    and (_is_jit_callable(dec.func) or _is_shard_map(dec.func))
                ):
                    defs[name] = fn

    # wrapped references: jax.jit(f) / shard_map(f, ...) anywhere
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if not (_is_jit_callable(node.func) or _is_shard_map(node.func)):
            continue
        for arg in node.args[:1]:
            if isinstance(arg, ast.Name):
                for scope in by_name.values():
                    fn = scope.get(arg.id)
                    if fn is not None:
                        defs[arg.id] = fn
    return defs


class _TaintChecker(ast.NodeVisitor):
    """Forward truthiness/taint pass over ONE jitted function body."""

    def __init__(self, mod: Module, fn: ast.FunctionDef,
                 findings: List[Finding]):
        self.mod = mod
        self.fn = fn
        self.findings = findings
        args = fn.args
        self.tainted: Set[str] = {
            a.arg for a in (
                list(args.posonlyargs) + list(args.args)
                + list(args.kwonlyargs)
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            ) if a.arg != "self"
        }

    # -- taint query -----------------------------------------------------------

    def _expr_tainted(self, expr: ast.expr) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
                # prune: anything derived from .shape/.ndim/... is static.
                # ast.walk has no pruning, so mark the subtree's names.
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name):
                        sub._gk_static = True  # type: ignore[attr-defined]
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d in ("len", "range", "enumerate"):
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Name):
                            sub._gk_static = True  # type: ignore[attr-defined]
        for node in ast.walk(expr):
            if (
                isinstance(node, ast.Name)
                and node.id in self.tainted
                and not getattr(node, "_gk_static", False)
            ):
                return True
        return False

    # -- statements ------------------------------------------------------------

    def visit_Assign(self, node: ast.Assign):
        tainted = self._expr_tainted(node.value)
        for tgt in node.targets:
            for name in ast.walk(tgt):
                if isinstance(name, ast.Name):
                    if tainted:
                        self.tainted.add(name.id)
                    else:
                        self.tainted.discard(name.id)
        # visit (not generic_visit): scalarizer/impure checks live in
        # visit_Call and must see the RHS call node itself
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign):
        if isinstance(node.target, ast.Name):
            if self._expr_tainted(node.value):
                self.tainted.add(node.target.id)
        self.visit(node.value)

    def _check_test(self, test: ast.expr, kind: str):
        if self._expr_tainted(test):
            self.findings.append(self.mod.finding(
                R_TRUTHY, test.lineno,
                f"{kind} on a traced value inside jitted "
                f"`{self.fn.name}` — use jnp.where/lax.cond; Python "
                "control flow concretizes the tracer",
            ))

    def visit_If(self, node: ast.If):
        self._check_test(node.test, "`if` truthiness")
        self.generic_visit(node)

    def visit_While(self, node: ast.While):
        self._check_test(node.test, "`while` truthiness")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert):
        self._check_test(node.test, "`assert` truthiness")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp):
        self._check_test(node.test, "conditional-expression truthiness")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        d = _dotted(node.func)
        if (
            d in _SCALARIZERS
            and node.args
            and self._expr_tainted(node.args[0])
        ):
            self.findings.append(self.mod.finding(
                R_TRUTHY, node.lineno,
                f"{d}() on a traced value inside jitted `{self.fn.name}` "
                "— scalar coercion concretizes the tracer",
            ))
        if d is not None:
            for prefix in _IMPURE_DOTTED:
                if d == prefix or d.startswith(prefix + "."):
                    self.findings.append(self.mod.finding(
                        R_IMPURE, node.lineno,
                        f"{d}() inside jitted `{self.fn.name}` executes "
                        "once at trace time and freezes into the "
                        "executable",
                    ))
                    break
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # nested defs trace separately
        return

    visit_AsyncFunctionDef = visit_FunctionDef


@register_pass
def trace_safety_pass(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        if mod.tree is None:
            continue
        # cheap pre-filter: modules that never mention jit/shard_map
        # have no compiled regions to check
        if "jit" not in mod.source and "shard_map" not in mod.source:
            continue
        for name, fn in sorted(_jitted_function_defs(mod).items()):
            _TaintChecker(mod, fn, findings).visit(
                ast.Module(body=fn.body, type_ignores=[])
            )
        # jit-in-loop: a jit construction lexically inside for/while
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and _is_jit_callable(sub.func):
                    findings.append(mod.finding(
                        R_JIT_LOOP, sub.lineno,
                        "jax.jit(...) constructed inside a loop — every "
                        "iteration re-hashes (or recompiles); hoist the "
                        "wrapper out of the loop",
                    ))
    return findings
