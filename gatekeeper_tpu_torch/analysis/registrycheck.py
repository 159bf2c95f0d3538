"""Cross-registry conformance (rules: unknown-fault-point,
undocumented-fault-point, undocumented-metric).

The `tools/check_observability.py` discipline, folded into gklint and
extended to the fault plane — purely static (AST + text), so linting
never imports the modules under check:

unknown-fault-point       every `faults.fire(<point>)` site must use a
                          constant defined in `faults/__init__.py` and
                          listed in ALL_POINTS; a raw string literal (or
                          an unlisted constant) is an unregistered point
                          chaos specs cannot target.
undocumented-fault-point  every ALL_POINTS entry appears in
                          docs/failure-modes.md (the operator contract
                          for chaos drills).
undocumented-metric       every `View("name", ...)` in
                          metrics/catalog.py appears in docs/metrics.md.

These project-level checks only run when the analyzed file set actually
contains the registries (linting a fixture directory skips them).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from .core import Finding, Module, Project, register_pass, register_rule

R_UNKNOWN_POINT = register_rule(
    "unknown-fault-point",
    "faults.fire() with a point that is not a registered ALL_POINTS "
    "constant",
)
R_UNDOC_POINT = register_rule(
    "undocumented-fault-point",
    "a fault point in faults.ALL_POINTS is missing from "
    "docs/failure-modes.md",
)
R_UNDOC_METRIC = register_rule(
    "undocumented-metric",
    "a metric view in metrics/catalog.py is missing from docs/metrics.md",
)

_FAULTS_MOD = "gatekeeper_tpu_torch/faults/__init__.py"
_CATALOG_MOD = "gatekeeper_tpu_torch/metrics/catalog.py"


def _find(project: Project, relpath: str) -> Optional[Module]:
    for mod in project.modules:
        if mod.relpath == relpath:
            return mod
    return None


def _read_doc(project: Project, rel: str) -> Optional[str]:
    path = os.path.join(project.root, rel)
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def _fault_registry(mod: Module):
    """(constant name -> point string, set of ALL_POINTS constant names)"""
    consts: Dict[str, str] = {}
    listed: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            if (
                isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                consts[tgt.id] = node.value.value
            elif tgt.id == "ALL_POINTS" and isinstance(
                node.value, (ast.Tuple, ast.List)
            ):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Name):
                        listed.add(elt.id)
    return consts, listed


@register_pass
def registry_pass(project: Project) -> List[Finding]:
    findings: List[Finding] = []

    faults_mod = _find(project, _FAULTS_MOD)
    if faults_mod is not None and faults_mod.tree is not None:
        consts, listed = _fault_registry(faults_mod)
        point_values = {consts[c] for c in listed if c in consts}

        # every fire() site uses a registered constant
        for mod in project.modules:
            if mod.tree is None or ".fire(" not in mod.source:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if not (
                    isinstance(func, ast.Attribute) and func.attr == "fire"
                ):
                    continue
                base = func.value
                base_name = getattr(base, "id", getattr(base, "attr", ""))
                if "faults" not in str(base_name):
                    continue
                if not node.args:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    if arg.value not in point_values:
                        findings.append(mod.finding(
                            R_UNKNOWN_POINT, node.lineno,
                            f"faults.fire({arg.value!r}) uses a string "
                            "literal not registered in faults.ALL_POINTS "
                            "— add a named constant so chaos specs can "
                            "target it",
                        ))
                elif isinstance(arg, ast.Attribute):
                    if arg.attr not in listed:
                        findings.append(mod.finding(
                            R_UNKNOWN_POINT, node.lineno,
                            f"faults.fire(faults.{arg.attr}) — "
                            f"{arg.attr} is not listed in "
                            "faults.ALL_POINTS",
                        ))

        # every registered point is documented
        doc = _read_doc(project, "docs/failure-modes.md")
        if doc is not None:
            for cname in sorted(listed):
                value = consts.get(cname)
                if value is not None and value not in doc:
                    findings.append(faults_mod.finding(
                        R_UNDOC_POINT, 1,
                        f"fault point {value!r} ({cname}) is not "
                        "documented in docs/failure-modes.md",
                    ))

    catalog_mod = _find(project, _CATALOG_MOD)
    if catalog_mod is not None and catalog_mod.tree is not None:
        doc = _read_doc(project, "docs/metrics.md")
        if doc is not None:
            for node in ast.walk(catalog_mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                fname = getattr(node.func, "id",
                                getattr(node.func, "attr", ""))
                if fname != "View" or not node.args:
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    if arg.value not in doc:
                        findings.append(catalog_mod.finding(
                            R_UNDOC_METRIC, node.lineno,
                            f"metric view {arg.value!r} is not "
                            "documented in docs/metrics.md",
                        ))
    return findings
