"""gklint for the port: gatekeeper_tpu_torch/analysis/ (a copy of the JAX
package's analysis/, its path-scoped rules naming gatekeeper_tpu_torch/)
and tools/gklint_torch.py, the CLI that lints the port.

The port's analysis gives the JAX package's findings (rule, file, line,
context) on every seeded fixture in tests/gklint_fixtures/; the port
lints clean through the CLI; a path-scoped rule fires on a file at a
gatekeeper_tpu_torch/ serving path and not at the same gatekeeper_tpu/
path (the JAX package's analysis the other way round); and the import
test covers the new modules."""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from gatekeeper_tpu import analysis as jax_analysis
from gatekeeper_tpu_torch import analysis as port_analysis

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "gklint_torch.py"
FIXTURES = REPO / "tests" / "gklint_fixtures"


def _findings(analysis, paths, root=REPO):
    return sorted(
        (f.rule, os.path.basename(f.path), f.line, f.context)
        for f in analysis.lint(str(root), [str(p) for p in paths])
    )


@pytest.mark.parametrize(
    "fixture", sorted(p.name for p in FIXTURES.glob("*.py")))
def test_the_ports_analysis_finds_what_the_jax_packages_finds(fixture):
    want = _findings(jax_analysis, [FIXTURES / fixture])
    assert _findings(port_analysis, [FIXTURES / fixture]) == want
    if fixture.endswith("_bad.py"):
        assert want, f"{fixture} seeds a finding"


def test_the_rule_catalogs_are_the_same():
    # the descriptions differ only where a provenance tag was dropped
    assert set(port_analysis.RULES) == set(jax_analysis.RULES)


def _run(*args):
    return subprocess.run(
        [sys.executable, str(TOOL), *args],
        capture_output=True, text=True, cwd=str(REPO), timeout=120,
    )


def test_the_port_lints_clean():
    """`python tools/gklint_torch.py gatekeeper_tpu_torch/` exits 0 with
    zero unsuppressed findings, and so does its default run."""
    for args in (("gatekeeper_tpu_torch/",), ()):
        r = _run(*args)
        assert r.returncode == 0, f"gklint found problems:\n{r.stderr}"
        assert "gklint: ok" in r.stdout


def test_the_cli_flags_the_fixtures():
    r = _run(str(FIXTURES), "--no-baseline", "--format=json")
    assert r.returncode == 1
    assert '"swallowed-exception"' in r.stdout


# a class queueing on a list it never bounds (queuebound's serving-path
# heuristic) and a broad except that swallows (failpolicy)
SEEDED = textwrap.dedent("""
    class Intake:
        def __init__(self):
            self.pending = []

        def push(self, item):
            self.pending.append(item)

    def handle(fn):
        try:
            fn()
        except Exception:
            pass
""")
ON_PATH = "on an admission/audit path"


def _seeded(root: pathlib.Path, pkg: str) -> pathlib.Path:
    path = root / pkg / "webhook" / "seeded.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(SEEDED)
    return path


@pytest.mark.parametrize("analysis,own,other", [
    (port_analysis, "gatekeeper_tpu_torch", "gatekeeper_tpu"),
    (jax_analysis, "gatekeeper_tpu", "gatekeeper_tpu_torch"),
])
def test_scoped_rules_fire_on_their_own_package(tmp_path, analysis, own,
                                                other):
    for pkg, scoped in ((own, True), (other, False)):
        path = _seeded(tmp_path, pkg)
        got = analysis.lint(str(tmp_path), [str(path)])
        queues = [f for f in got if f.rule == "unbounded-queue"]
        swallows = [f for f in got if f.rule == "swallowed-exception"]
        assert len(swallows) == 1
        if scoped:
            assert [f.context for f in queues] == ["Intake.__init__"], got
            assert ON_PATH in swallows[0].message
        else:
            assert queues == [], got
            assert ON_PATH not in swallows[0].message


def test_the_import_check_covers_the_new_modules():
    from .test_torch_imports import _port_files

    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    new = {"gatekeeper_tpu_torch/kube/apiserver.py"} | {
        f"gatekeeper_tpu_torch/analysis/{p.name}"
        for p in (REPO / "gatekeeper_tpu" / "analysis").glob("*.py")}
    assert len(new) == 10 and new <= files
