"""The process entry's modules are copies: each port file equals the JAX
package's after the package name is replaced and the JAX package's
provenance tags (issue, PR and review numbers in comments and docstrings,
SCRUB) are dropped, except the functions named in CHANGED, which the
port changed on purpose (the driver wiring, the parser and the refused
flags of main.py, compilestats' pytree walk without JAX, the code
fingerprint over the kernels' sources, and where the snapshot writer and
loader move the resident mask between the host and the device).  A
reader of the port reads only those."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "gatekeeper_tpu"
PORT_PKG = ROOT / "gatekeeper_tpu_torch"

COPIED = (
    "__main__.py", "logging.py", "deadline.py", "operations.py",
    "faults/__init__.py", "faults/plane.py",
    "syncutil/__init__.py", "util/seal.py",
    "apis/config.py", "apis/status.py",
    "process/__init__.py", "process/excluder.py",
    "kube/__init__.py", "kube/inmem.py", "kube/clients.py",
    "kube/http_client.py",
    "metrics/__init__.py", "metrics/catalog.py", "metrics/exporter.py",
    "metrics/views.py",
    "obs/__init__.py", "obs/trace.py", "obs/slo.py", "obs/decisionlog.py",
    "obs/routeledger.py", "obs/debug.py", "obs/flightrec.py",
    "obs/costs.py", "obs/brownout.py", "obs/profiler.py",
    "obs/reactorobs.py", "obs/compilestats.py",
    "watch/__init__.py", "watch/manager.py", "watch/set.py",
    "readiness/__init__.py", "readiness/tracker.py",
    "controllers/__init__.py", "controllers/base.py",
    "controllers/config.py", "controllers/constraint.py",
    "controllers/constrainttemplate.py", "controllers/registry.py",
    "controllers/status.py", "controllers/sync.py",
    "upgrade/__init__.py", "certs/__init__.py", "certs/rotator.py",
    "webhook/__init__.py", "webhook/policy.py",
    "webhook/namespacelabel.py", "webhook/server.py",
    "audit/__init__.py", "audit/manager.py",
    "snapshot/__init__.py", "snapshot/format.py", "snapshot/writer.py",
    "snapshot/loader.py",
    "main.py",
)

# file -> the top-level names (functions, classes' methods as
# "Class.method", assigned constants) the port changed or added
CHANGED = {
    "main.py": {
        # the parser: prog, --driver interp|torch (default torch),
        # --torch-device, and the refused flags' defaults and help
        "build_parser",
        # the flags whose machinery the port lacks, refused at construction
        "UNPORTED_FLAGS", "refuse_unported_flags",
        # the refusal and TorchDriver in place of TpuDriver
        "App.__init__",
        # the kernels loaded (wait_ready) before anything serves; the jax
        # profiler server left out
        "App.start", "App.stop",
    },
    "obs/compilestats.py": {
        # sums nbytes over tensors and numpy arrays without jax's pytrees
        "tree_nbytes",
    },
    "util/seal.py": {
        # hashes the kernels' sources (.cu, .cuh) too: a snapshot's delta
        # basis made by other kernels is never restored
        "code_fingerprint",
    },
    "controllers/config.py": {
        # drops only the data the new config no longer keeps, where the
        # JAX package wipes it all: a warm-resumed inventory survives the
        # Config's first reconcile
        "ConfigController.reconcile",
    },
    "snapshot/writer.py": {
        # the resident mask (a tensor on the card, or a mesh sweep's
        # ShardedMask) brought to the host with .cpu(), not np.asarray
        "SnapshotWriter._resolve_mask",
    },
    "snapshot/loader.py": {
        # the restored mask placed on the driver's device, or in slabs on
        # the mesh's shards, without jax.device_put
        "SnapshotLoader._restore_delta",
    },
}

# file -> (JAX text, port text): a change of a whole statement.  The
# port's __main__ runs only as a script, so that importing it (as
# tests/test_torch_imports.py imports every module) starts no process
REPLACED = {
    "__main__.py": ("\nmain()\n", '\nif __name__ == "__main__":\n    main()\n'),
}


# (pattern, replacement), in order: the tags name the JAX package's
# issues, PRs and review rounds, which mean nothing in the port; every
# match lies in a comment or a docstring
SCRUB = (
    (r" \(ISSUE \d+[^(),\n]*\)", ""),
    (r"\(ISSUE \d+, ", "("),
    (r", ISSUE \d+\)", ")"),
    (r"ISSUE \d+ ", ""),
    (r" \(r\d+ VERDICT #\d+\)", ""),
    (r"PR 2 instrumented (.*) and PR 4 added",
     r"Earlier work instrumented \1 and added"),
    (r"the PR (\d+)\n(\s*)(#?\s*)", r"the\n\2\3"),
    (r" / PR \d+ ", " / "),
    (r" \(round-\d+ VERDICT: [^)]*\)", ""),
)
TAGS = re.compile(r"ISSUE \d|\bPR \d|VERDICT")


def _renamed(text: str) -> str:
    text = text.replace("gatekeeper_tpu", "gatekeeper_tpu_torch")
    for pattern, replacement in SCRUB:
        text = re.sub(pattern, replacement, text)
    return text


def _pieces(text: str) -> dict:
    """name -> source of each top-level function, class method and
    assignment; every other top-level statement keyed by its own text."""
    tree = ast.parse(text)
    out = {}

    def name_of(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return node.name
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            return node.targets[0].id
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            return node.target.id
        return None

    for node in tree.body:
        src = ast.get_source_segment(text, node, padded=True)
        name = name_of(node)
        if isinstance(node, ast.ClassDef):
            head = []
            for sub in node.body:
                sub_name = name_of(sub)
                sub_src = ast.get_source_segment(text, sub, padded=True)
                if sub_name is None:
                    head.append(sub_src)
                else:
                    out[f"{node.name}.{sub_name}"] = sub_src
            out[node.name] = "\n".join(
                [ast.unparse(b) for b in node.bases]
                + [ast.unparse(d) for d in node.decorator_list] + head)
        elif name is not None:
            out[name] = src
        else:
            out[f"<{src}>"] = src
    return out


def test_the_list_covers_every_copied_file():
    """Every port file with a JAX twin of the same path, other than the
    modules earlier slices ported by hand, is listed as a copy."""
    earlier = {
        p.relative_to(PORT_PKG).as_posix()
        for p in PORT_PKG.rglob("*.py")
        if (JAX_PKG / p.relative_to(PORT_PKG)).exists()
    } - set(COPIED)
    # modules of the earlier slices: the engine, the client, the target,
    # the rego front end and the ops / parallel layers they rewrote
    assert all(
        path.split("/")[0] in {"client", "engine", "rego", "target", "ops",
                               "parallel", "native", "apis", "util"}
        or path in {"__init__.py", "version.py"}
        for path in earlier
    ), sorted(earlier)
    assert set(CHANGED) | set(REPLACED) <= set(COPIED)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_the_jax_module_but_for_its_named_changes(rel):
    jax_text = _renamed((JAX_PKG / rel).read_text())
    port_text = (PORT_PKG / rel).read_text()
    assert not TAGS.search(port_text), f"{rel} keeps a provenance tag"
    if rel in REPLACED:
        old, new = REPLACED[rel]
        assert jax_text.count(old) == 1 and port_text.count(new) == 1
        jax_text = jax_text.replace(old, new)
    changed = CHANGED.get(rel, set())
    if not changed:
        assert port_text == jax_text, f"{rel} differs from its JAX twin"
        return
    want, got = _pieces(jax_text), _pieces(port_text)
    missing = changed - set(got)
    assert not missing, f"{rel}: named changes not found: {missing}"
    for name in sorted(set(want) | set(got)):
        if name in changed:
            continue
        assert name in want, f"{rel}: {name!r} added but not named"
        assert name in got, f"{rel}: {name!r} removed but not named"
        assert got[name] == want[name], f"{rel}: {name!r} differs"
    # the module docstring and imports are pieces too: unchanged
    assert ast.get_docstring(ast.parse(port_text)) == ast.get_docstring(
        ast.parse(jax_text))


def test_a_changed_function_is_really_changed():
    """No name stays on the exception list once it equals the JAX one."""
    for rel, names in CHANGED.items():
        want = _pieces(_renamed((JAX_PKG / rel).read_text()))
        got = _pieces((PORT_PKG / rel).read_text())
        for name in names:
            assert got[name] != want.get(name), f"{rel}: {name} unchanged"
